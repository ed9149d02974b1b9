"""The port's lock-order audit of its own tests
(``alluxio_tpu_torch/lint/pytest_lockaudit.py``): every audited lock of
the port's table is a proxy on a live port cluster, every port test file
pulls the audit fixtures in, and one write, rename and delete on the
port's ``LocalCluster`` gives the same observed order edges as the same
operations on JAX's ``LocalCluster`` under JAX's plugin."""

import ast
import contextlib
import importlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from alluxio_tpu_torch.lint import pytest_lockaudit as pla
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ("port_lock_order_audit", "port_lockaudit_install")

if not pla.ENABLED:  # pragma: no cover - env override
    pytest.skip("ATPU_LOCK_AUDIT=0", allow_module_level=True)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """A port LocalCluster with its job service and a one-master HA
    cluster (Raft journal, fault-tolerant master), both built after the
    plugin patched the port's classes."""
    from alluxio_tpu_torch.minicluster import LocalCluster
    from alluxio_tpu_torch.minicluster.ha_cluster import HaCluster

    lc = LocalCluster(str(tmp_path_factory.mktemp("lc")), num_workers=1,
                      start_job_service=True).start()
    ha = HaCluster(str(tmp_path_factory.mktemp("ha")), num_masters=1)
    try:
        ha.start()
        yield {"lc": lc, "ha": ha}
    finally:
        ha.stop()
        lc.stop()


def _hbm_store():
    from alluxio_tpu_torch.client.cache.hbm_store import HbmPageStore

    return HbmPageStore(1 << 20, device="cpu")


#: audited name -> the live object that holds it
OWNERS = {
    "InodeTree.lock": lambda c: c["lc"].master.fs_master.inode_tree,
    "InodeTree.registry_lock":
        lambda c: c["lc"].master.fs_master.inode_tree,
    "LocalJournalSystem._lock": lambda c: c["lc"].master.journal,
    "BlockMaster._lock": lambda c: c["lc"].master.block_master,
    "BlockMaster._reserve_lock": lambda c: c["lc"].master.block_master,
    "FileSystemMaster._persist_mutex": lambda c: c["lc"].master.fs_master,
    "FileSystemMaster._listing_cache_lock":
        lambda c: c["lc"].master.fs_master,
    "MetricsStore._lock": lambda c: c["lc"].master.metrics_master.store,
    "MetricsHistory._lock": lambda c: c["lc"].master.metrics_master.history,
    "MetricsHistory._pending_lock":
        lambda c: c["lc"].master.metrics_master.history,
    "TieredBlockStore._alloc_lock": lambda c: c["lc"].workers[0].worker.store,
    "BlockLockManager._meta_lock":
        lambda c: c["lc"].workers[0].worker.store._locks,
    "RaftNode.lock": lambda c: c["ha"].masters[0].journal.node,
    "JobMaster._lock": lambda c: c["lc"].job_master.job_master,
    "FaultTolerantMasterProcess._promote_lock": lambda c: c["ha"].masters[0],
    "HbmPageStore._lock": lambda c: _hbm_store(),
    "MemObjectStore._lock":
        lambda c: _port("underfs.object_base").MemObjectStore(),
    "KeystoneSession._lock": lambda c: _port("underfs.swift").KeystoneSession(
        "http://127.0.0.1:1/v3", "u", "pw", "proj"),
    "IndexedSet._lock": lambda c: _port("utils.collections").IndexedSet(
        _port("utils.collections").FieldIndex("id", id)),
    "DirectedAcyclicGraph._lock":
        lambda c: _port("utils.collections").DirectedAcyclicGraph(),
    "LogServerProcess._lock": lambda c: _log_server(c),
    "FuseFs._lock": lambda c: _port("fuse.fs").FuseFs(c["lc"].file_system()),
    "_OpenFile.lock": lambda c: _port("fuse.fs")._OpenFile(),
    "_S3State.lock":
        lambda c: _port("proxy.process")._S3State(None, "/s3"),
    "StripeBudget._lock": lambda c: _port("qos").StripeBudget(),
}


def _log_server(c):
    """A log server on an ephemeral loopback port, started and stopped
    at once: the proxy is set in its constructor."""
    srv = _port("logserver.process").LogServerProcess(
        os.path.join(c["lc"]._base, "logserver"))
    srv.start()
    srv.stop()
    return srv


def _port(name):
    return importlib.import_module(f"alluxio_tpu_torch.{name}")


@pytest.mark.parametrize("entry", pla._STATIC, ids=lambda e: e[3])
def test_static_lock_carries_its_proxy(entry):
    """The locks made at import (the UFS registry's, the mem:// bucket
    table) are audited under their names, and a call that takes them
    reports to the current auditor."""
    module, owner, attr, name = entry
    holder = _port(module.split(".", 1)[1])
    if owner:
        holder = getattr(holder, owner)
    lock = getattr(holder, attr)
    assert isinstance(lock, pla._LockProxy) and lock._name == name
    _port("underfs.registry").create_ufs("mem://lockaudit/x")
    assert name in pla.acquired_names()


def test_table_names_every_owner():
    assert sorted(OWNERS) == sorted(e[3] for e in pla._INSTRUMENT)


@pytest.mark.parametrize("entry", pla._INSTRUMENT, ids=lambda e: e[3])
def test_port_class_carries_its_proxy(clusters, entry):
    module, cls_name, attr, name = entry
    owner = OWNERS[name](clusters)
    assert type(owner).__name__ == cls_name
    lock = getattr(owner, attr)
    assert isinstance(lock, pla._LockProxy)
    assert lock._name == name
    assert lock._auditor is pla._DELEGATE


@pytest.mark.parametrize("pool,name", [("lock_manager", pla.INODE_LOCK),
                                       ("edge_lock_manager", pla.EDGE_LOCK)])
def test_stripe_pools_hand_out_proxies(clusters, pool, name):
    mgr = getattr(clusters["lc"].master.fs_master.inode_tree, pool)
    key = ("lockaudit-probe", name)
    lock = mgr.checkout(key)
    try:
        assert isinstance(lock, pla._LockProxy) and lock._name == name
    finally:
        mgr.checkin(key)


def test_a_test_runs_under_a_current_auditor(clusters):
    """The fixture made an auditor current for this test, and the
    cluster's locks report to it."""
    current = pla._DELEGATE.current
    assert current is not None
    clusters["lc"].file_system().create_directory("/lockaudit-probe",
                                                  recursive=True)
    assert "InodeTree.lock" in pla.acquired_names()
    assert pla.observed_edges() == sorted(current.edges)


def _imports_fixtures(tree: ast.Module) -> bool:
    for node in tree.body:  # module level only
        if isinstance(node, ast.ImportFrom) and \
                node.module == "alluxio_tpu_torch.lint.pytest_lockaudit" \
                and set(FIXTURES) <= {a.name for a in node.names}:
            return True
    return False


def _opts_out(tree: ast.Module) -> bool:
    """``pytest.mark.no_lockaudit`` anywhere (decorator or pytestmark)."""
    return any(isinstance(n, ast.Attribute) and n.attr == "no_lockaudit"
               for n in ast.walk(tree))


@pytest.mark.parametrize("path", sorted(ROOT.glob("tests/test_torch_*.py")),
                         ids=lambda p: p.name)
def test_every_port_test_file_is_audited(path):
    """A new port test cannot run unaudited: it must import both
    fixtures at module level, and no port test opts out."""
    tree = ast.parse(path.read_text())
    assert _imports_fixtures(tree), \
        f"{path.name} does not import {FIXTURES} from the port's plugin"
    assert not _opts_out(tree), f"{path.name} opts a test out of the audit"


@contextlib.contextmanager
def _jax_audited():
    """A fresh JAX auditor current on JAX's own plugin delegate for the
    block (the JAX plugin's per-test auditor is restored after)."""
    from alluxio_tpu.lint import pytest_lockaudit as jpla
    from alluxio_tpu.utils.race import LockOrderAuditor

    if not jpla._ENABLED:  # pragma: no cover - env override
        pytest.skip("ATPU_LOCK_AUDIT=0")
    auditor = LockOrderAuditor()
    prev = jpla._DELEGATE.current
    jpla._DELEGATE.current = auditor
    try:
        yield auditor
    finally:
        jpla._DELEGATE.current = prev


def _namespace_edges(pkg, base, audited):
    import importlib

    cluster = importlib.import_module(f"{pkg}.minicluster").LocalCluster
    with cluster(str(base), num_workers=1) as c:
        fs = c.file_system()
        fs.create_directory("/a", recursive=True)
        with audited() as aud:
            fs.write_all("/a/f", b"x" * 4096)
            fs.rename("/a/f", "/a/g")
            fs.delete("/a/g")
        assert not fs.exists("/a/g")
    return sorted(aud.edges), aud.inversions()


def test_write_rename_delete_edges_equal_jax(tmp_path):
    jax = _namespace_edges("alluxio_tpu", tmp_path / "jax", _jax_audited)
    port = _namespace_edges("alluxio_tpu_torch", tmp_path / "port",
                            pla.audited)
    assert port == jax
    edges, inversions = port
    assert inversions == []
    # the canonical order: tree lock -> inode stripes -> edge stripes ->
    # journal -> block map
    for edge in (("InodeTree.lock", "InodeTree.inode_lock"),
                 ("InodeTree.inode_lock", "InodeTree.edge_lock"),
                 ("InodeTree.edge_lock", "LocalJournalSystem._lock"),
                 ("LocalJournalSystem._lock", "BlockMaster._lock")):
        assert edge in edges


def _outside_pytest_drill():
    """The drill's use of :func:`audited`, run by the test below in a
    child interpreter that starts no cluster: the outer block stands for
    the auditor a test runs under."""
    with pla.audited():
        with pla.audited() as aud:
            a = pla._proxy(threading.Lock(), "fx.A")
            b = pla._proxy(threading.Lock(), "fx.B")

            def ab():
                with a:
                    with b:
                        pass

            def ba():
                with b:
                    with a:
                        pass

            for fn in (ab, ba):
                t = threading.Thread(target=fn)
                t.start()
                t.join(5)
            assert aud.inversions() == [("fx.A", "fx.B")]
            # the audited names acquired in the block: the child runs no
            # cluster, so only the pair's own may show
            assert [n for n in pla.acquired_names()
                    if n != "JobMaster._lock"] == ["fx.A", "fx.B"]
        # the outer auditor is current again, and never saw the pair
        assert ("fx.A", "fx.B") not in pla._DELEGATE.current.edges


def test_install_works_outside_pytest_and_reports_an_inversion():
    """:func:`audited` is the drill's entry point: proxies report to it,
    and two locks taken in both orders on two threads are an
    inversion. The block runs in a child interpreter: :func:`audited`
    makes its auditor current for the whole process, so a cluster of
    this module's fixtures (its Raft node, its job master) could take an
    audited lock inside it."""
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location("
            f"'lockaudit_drill', {str(Path(__file__))!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "mod._outside_pytest_drill()\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
