"""The port's master against the JAX package's, on the CPU.

- A seeded script of about 200 operations (mkdir, create, new block,
  complete, rename, delete, mount, unmount, set_attribute with TTL, pinned
  and mode, set_acl, free, metadata loads from a local UFS, worker
  registration, heartbeats and commits, and lost-worker and TTL detection
  on a ``ManualClock``) goes through both packages' ``FileSystemMaster`` +
  ``BlockMaster``, each over a ``LocalJournalSystem``. After every
  operation the result or the error type, ``get_status`` and
  ``list_status`` as wire dicts, the block locations, the workers and the
  mount points are equal; so is the sequence of journal entries (type and
  payload) the two journals hold at the end.
- The helpers the file master calls inline: ``AlluxioURI``, the
  authorization bits and ACLs, the path properties and the config checker,
  the metastore factory — each against its JAX counterpart.
- The port's master process refuses the opt-in components it does not
  have (a typed error), and the web server and remediation keys build
  their component in both packages' master processes. (An LSM-native checkpoint restoring across
  packages and kinds is ``tests/test_torch_metastore.py``'s.)
"""

import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.testutils.torch_master import (  # noqa: E402
    PACKAGES, Masters, make_script, mod, resolve,
)

SEEDS = (0, 1, 2, 3)


def _journal_entries(m: Masters):
    fmt = mod(m.pkg, "journal.format")
    system = mod(m.pkg, "journal.system")
    logs = os.path.join(m.journal_dir, "logs")
    out = []
    for seg in system.sorted_segments(logs):
        with open(os.path.join(logs, seg), "rb") as f:
            out += [(e.sequence, e.type, m.norm(e.payload))
                    for e in fmt.JournalEntry.decode_stream(f)]
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_operation_script_matches_jax(tmp_path, seed):
    script = make_script(seed, 200)
    masters = [Masters(pkg, str(tmp_path / pkg), seed=seed).start()
               for pkg in PACKAGES]
    seen = ([], [])
    try:
        for i, op in enumerate(script):
            obs = [m.run(resolve(op, seen[k]))
                   for k, m in enumerate(masters)]
            for k in (0, 1):
                seen[k].append(obs[k])
            assert obs[1] == obs[0], f"operation {i}: {op}"
    finally:
        for m in masters:
            m.stop()
    errors = {o["result"][1] for o in seen[0]
              if isinstance(o["result"], tuple)}
    # the script reaches the typed errors as well as the happy paths
    assert {"FileDoesNotExistError", "PermissionDeniedError"} <= errors
    want, got = (_journal_entries(m) for m in masters)
    assert got == want and len(want) > 100


# -- the file master's helpers ------------------------------------------------
_URIS = ("/", "/a", "/a/b/", "//a//b/./c", "/a/b/../c", "atpu://host:1/x/y",
         "a/b", "/a/b/c.bin")


@pytest.mark.parametrize("text", _URIS)
def test_uri_matches_jax(text):
    out = []
    for pkg in PACKAGES:
        uri = mod(pkg, "utils.uri").AlluxioURI(text)
        parent = uri.parent()
        out.append((str(uri), uri.path, uri.name, uri.depth(), uri.is_root(),
                    uri.scheme, uri.authority, uri.path_components(),
                    str(parent) if parent is not None else None,
                    str(uri.join("z")),
                    uri.is_ancestor_of(type(uri)("/a/b/c/d"))))
    assert out[1] == out[0]


def test_check_bits_matches_jax():
    rng = np.random.default_rng(5)
    users = ("alice", "bob", "carol")
    got = {pkg: [] for pkg in PACKAGES}
    cases = []
    for _ in range(300):
        mode = int(rng.integers(0, 0o1000))
        user = users[int(rng.integers(3))]
        owner = users[int(rng.integers(3))]
        entries = [e for e in ("user:bob:r-x", "group:eng:rw-",
                               "user:carol:---", "mask::r-x")
                   if rng.random() < 0.4]
        cases.append((int(rng.integers(1, 8)), user, owner, mode, entries))
    for pkg in PACKAGES:
        auth = mod(pkg, "security.authorization")
        for bits, user, owner, mode, entries in cases:
            acl = auth.AccessControlList.from_entries(entries)
            got[pkg].append((
                auth.check_bits(bits_wanted=bits, user=user,
                                groups=("eng",) if user == "bob" else (),
                                owner=owner, group="eng", mode=mode,
                                acl_entries=entries),
                acl.to_entries(), acl.to_entries(is_default=True),
                acl.is_empty(), auth.bits_to_string(bits)))
    assert got[PACKAGES[1]] == got[PACKAGES[0]]


def test_path_properties_and_config_report_match_jax():
    out = []
    for pkg in PACKAGES:
        pp = mod(pkg, "master.path_properties")
        journal = mod(pkg, "journal").NoopJournalSystem()
        props = pp.PathProperties(journal)
        props.add("/a", {"atpu.user.file.writetype.default": "THROUGH"})
        props.add("/a/b", {"atpu.user.file.writetype.default": "MUST_CACHE",
                           "atpu.user.file.replication.min": "2"})
        props.remove("/a/b", ["atpu.user.file.replication.min"])
        resolved = [pp.resolve_path_property(
            props.get_all(), p, "atpu.user.file.writetype.default")
            for p in ("/", "/a", "/a/x", "/a/b/c", "/ab")]
        checker = pp.ConfigurationChecker()
        checker.register("master", {"atpu.security.authentication.type":
                                    "SIMPLE", "atpu.user.file.replication.max":
                                    "3"})
        checker.register("worker-1", {"atpu.security.authentication.type":
                                      "NOSASL", "atpu.user.file.replication.max":
                                      "5"})
        out.append((props.get_all(), props.hash(), resolved,
                    checker.report(), props.snapshot()))
    assert out[1] == out[0]
    assert out[0][3]["status"] == "FAILED"


@pytest.mark.parametrize("kind", ("HEAP", "heap", "SQLITE", "LSM", "CACHING",
                                  "CACHING:LSM", "ROCKS"))
def test_metastore_factory(tmp_path, kind):
    """Every kind gives the store class JAX gives (a caching store over the
    same backing class where JAX wraps one); a kind neither package knows
    raises the same typed error."""
    from alluxio_tpu.master.metastore import create_inode_store as jax_create
    from alluxio_tpu.utils.exceptions import (
        InvalidArgumentError as JaxInvalidArgumentError,
    )
    from alluxio_tpu_torch.master.metastore import create_inode_store
    from alluxio_tpu_torch.utils.exceptions import InvalidArgumentError

    if kind == "ROCKS":
        with pytest.raises(InvalidArgumentError):
            create_inode_store(kind, str(tmp_path / "port"))
        with pytest.raises(JaxInvalidArgumentError):
            jax_create(kind, str(tmp_path / "jax"))
        return

    def shape(store):
        backing = getattr(store, "backing", None)
        return (type(store).__name__, store.stats().get("kind"),
                None if backing is None else type(backing).__name__)

    stores = [create(kind, str(tmp_path / name), cache_size=8)
              for create, name in ((jax_create, "jax"),
                                   (create_inode_store, "port"))]
    try:
        assert shape(stores[1]) == shape(stores[0])
        assert type(stores[1]).__module__.startswith("alluxio_tpu_torch.")
    finally:
        for store in stores:
            store.close()


@pytest.mark.parametrize("key", (
    "atpu.master.rpc.admission.enabled",
    "atpu.master.update.check.enabled", "atpu.master.daily.backup.enabled",
    "atpu.master.journal.init.from.backup",
))
def test_master_process_refuses_unported_components(tmp_path, key):
    from alluxio_tpu_torch.conf import Configuration, Keys
    from alluxio_tpu_torch.master.process import MasterProcess
    from alluxio_tpu_torch.utils.exceptions import NotSupportedError

    conf = Configuration(load_env=False)
    conf.set(Keys.MASTER_JOURNAL_FOLDER, str(tmp_path / "journal"))
    conf.set(key, str(tmp_path / "backup.bak")
             if key.endswith("backup") else True)
    with pytest.raises(NotSupportedError, match=key.replace(".", r"\.")):
        MasterProcess(conf, root_ufs_uri=str(tmp_path))


@pytest.mark.parametrize("key, attr", (
    ("atpu.master.web.enabled", "web_server"),
    ("atpu.master.remediation.enabled", "remediation"),
))
def test_master_process_builds_the_switched_on_component(tmp_path, key,
                                                         attr):
    """The key builds its component in both packages' started master
    processes, and only that one (the other stays None)."""
    other = {"web_server": "remediation",
             "remediation": "web_server"}[attr]
    for pkg in PACKAGES:
        conf_mod = mod(pkg, "conf")
        keys = conf_mod.Keys
        conf = conf_mod.Configuration(load_env=False)
        conf.set(keys.MASTER_JOURNAL_FOLDER, str(tmp_path / pkg / "journal"))
        conf.set(keys.MASTER_RPC_PORT, 0)
        conf.set(keys.MASTER_WEB_PORT, 0)
        conf.set(keys.MASTER_FASTPATH_ENABLED, False)
        conf.set(key, True)
        process = mod(pkg, "master.process").MasterProcess(
            conf, root_ufs_uri=str(tmp_path / pkg / "ufs"))
        process.start()
        try:
            assert getattr(process, attr) is not None, pkg
            assert getattr(process, other) is None, pkg
            assert type(getattr(process, attr)).__module__.startswith(
                f"{pkg}."), pkg
            if attr == "remediation":
                assert process.remediation.on_alerts in \
                    process.health_monitor.alert_listeners
            else:
                assert process.web_port == process.web_server.port > 0
        finally:
            process.stop()


def test_master_process_runs_the_named_metrics_sink(tmp_path):
    """``atpu.metrics.sinks`` gives the master a sink heartbeat in both
    packages: its JSON-lines file fills with the master's metrics."""
    import json
    import time

    for pkg in PACKAGES:
        conf_mod = mod(pkg, "conf")
        keys = conf_mod.Keys
        conf = conf_mod.Configuration(load_env=False)
        sink = tmp_path / pkg / "metrics.jsonl"
        conf.set(keys.MASTER_JOURNAL_FOLDER, str(tmp_path / pkg / "journal"))
        conf.set(keys.MASTER_RPC_PORT, 0)
        conf.set(keys.MASTER_FASTPATH_ENABLED, False)
        conf.set(keys.METRICS_SINKS, "jsonl")
        conf.set(keys.METRICS_SINK_JSONL_PATH, str(sink))
        conf.set(keys.METRICS_SINK_INTERVAL, "100ms")
        process = mod(pkg, "master.process").MasterProcess(
            conf, root_ufs_uri=str(tmp_path / pkg / "ufs"))
        process.start()
        try:
            deadline = time.monotonic() + 30.0
            while not (sink.exists() and sink.read_text().strip()):
                assert time.monotonic() < deadline, pkg
                time.sleep(0.05)
        finally:
            process.stop()
        row = json.loads(sink.read_text().splitlines()[0])
        assert any(k.startswith("Master.") for k in row["metrics"]), pkg


def test_embedded_journal_is_refused(tmp_path):
    from alluxio_tpu_torch.journal import create_journal_system

    with pytest.raises(ValueError, match="EMBEDDED"):
        create_journal_system("EMBEDDED", str(tmp_path))


# -- the reference's copied faults, repaired in the port ----------------------
JAX, PORT = PACKAGES


class _DrainRace(set):
    """A persist-request set whose ``clear()`` first runs ``race``: a
    persist requested from another thread lands between the drain's copy
    of the set and its clear."""

    def __init__(self, items, race) -> None:
        super().__init__(items)
        self._race = race

    def clear(self) -> None:
        race, self._race = self._race, None
        if race is not None:
            race()
        super().clear()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_persist_request_made_during_a_drain_is_kept(tmp_path, pkg):
    """The JAX drain copies the set and then clears it with no lock: an
    id added between the two is cleared unseen, so its file is never
    persisted. The port drains under the lock every add takes, so the
    add waits and the next drain returns it."""
    import threading

    m = Masters(pkg, str(tmp_path)).start()
    try:
        fsm = m.fsm
        for path in ("/a", "/b"):
            fsm.create_file(path)
            fsm.complete_file(path, length=0)
        fsm.schedule_async_persistence("/a")
        a, b = (fsm.get_status(p).file_id for p in ("/a", "/b"))
        adder = threading.Thread(target=fsm.schedule_async_persistence,
                                 args=("/b",))

        def race():
            adder.start()
            # the JAX add never blocks, so it lands here, between the
            # copy and the clear; the port's add waits for the lock
            adder.join(timeout=None if pkg == JAX else 0.5)

        fsm._persist_requests = _DrainRace(fsm._persist_requests, race)
        first = fsm.pop_persist_requests()
        adder.join(timeout=10)
        assert not adder.is_alive()
        second = fsm.pop_persist_requests()
    finally:
        m.stop()
    assert a in first
    assert (b in first | second) == (pkg == PORT)


def _persist_fixture(m: Masters, op: str):
    """An operation that must make UFS directories for ``/d1/d2``, two
    unpersisted directories: completing a file under them with a UFS
    fingerprint, marking such a file persisted, committing its persist
    (a zero-block file: the master creates the UFS object), or renaming
    a persisted file under them. Returns the operation as a callable."""
    fsm = m.fsm
    fsm.create_file("/other")
    fsm.create_directory("/d1/d2", recursive=True)
    if op == "rename":
        fsm.create_file("/s/f", recursive=True)
        fsm.complete_file("/s/f", length=0)
        fsm.mark_persisted("/s/f", "fp")
        uri = mod(m.pkg, "utils.uri").AlluxioURI("/s/f")
        with open(fsm.mount_table.resolve(uri).ufs_path, "wb"):
            pass
        return lambda: fsm.rename("/s/f", "/d1/d2/f")
    fsm.create_file("/d1/d2/f")
    if op == "complete":
        return lambda: fsm.complete_file("/d1/d2/f", length=0,
                                         ufs_fingerprint="fp")
    fsm.complete_file("/d1/d2/f", length=0)
    if op == "commit_persist":
        file_id = fsm.get_status("/d1/d2/f").file_id
        return lambda: fsm.commit_persist("/d1/d2/f", "",
                                          expected_id=file_id)
    return lambda: fsm.mark_persisted("/d1/d2/f", "fp")


def _root_ufs(m: Masters):
    uri = mod(m.pkg, "utils.uri").AlluxioURI("/")
    return m.fsm._ufs.get(m.fsm.mount_table.resolve(uri).mount_id)


@pytest.mark.parametrize("op", ("complete", "mark_persisted", "rename"))
@pytest.mark.parametrize("pkg", PACKAGES)
def test_ufs_dirs_are_made_outside_the_tree_lock(tmp_path, monkeypatch,
                                                 pkg, op):
    """The JAX master makes the breadcrumb directories while it holds
    the tree's exclusive lock, so one slow UFS call stalls the whole
    namespace. The port decides under the lock which directories it
    needs and makes them after releasing it: a ``get_status`` of an
    unrelated path answers while the UFS call is blocked. (On JAX the
    test only records that the lock is write-held, and blocks nothing.)"""
    import threading

    m = Masters(pkg, str(tmp_path)).start()
    release = threading.Event()
    try:
        run = _persist_fixture(m, op)
        ufs = _root_ufs(m)
        entered = threading.Event()
        held = []
        real = ufs.mkdirs

        def mkdirs(path, *args, **kwargs):
            write_held = \
                m.fsm.inode_tree.lock._writer is threading.current_thread()
            held.append(write_held)
            if not write_held:
                entered.set()
                assert release.wait(10)
            return real(path, *args, **kwargs)

        monkeypatch.setattr(ufs, "mkdirs", mkdirs)
        worker = threading.Thread(target=run)
        worker.start()
        if pkg == JAX:
            worker.join(timeout=10)
            assert held and all(held)
        else:
            assert entered.wait(10)
            answered = []
            reader = threading.Thread(
                target=lambda: answered.append(m.fsm.get_status("/other")))
            reader.start()
            reader.join(timeout=10)
            assert answered, "get_status waited for the UFS call"
            release.set()
            worker.join(timeout=10)
            assert held and not any(held)
        assert not worker.is_alive()
        assert m.fsm.get_status("/d1/d2").persistence_state == "PERSISTED"
    finally:
        release.set()
        m.stop()


@pytest.mark.parametrize("op", ("complete", "mark_persisted", "rename",
                                "commit_persist"))
@pytest.mark.parametrize("pkg", PACKAGES)
def test_failed_ufs_mkdirs_leaves_directories_unpersisted(tmp_path,
                                                          monkeypatch,
                                                          pkg, op):
    """The JAX master swallows a failed breadcrumb mkdirs and journals
    the directories PERSISTED all the same, so the namespace claims UFS
    directories that do not exist. The port never lets a PERSISTED file
    sit under a NOT_PERSISTED directory (a rename of that directory
    would skip the UFS rename, and metadata sync would bring the old
    tree back): the op raises ``UnavailableError`` before it journals
    anything or touches the UFS, the directories stay unpersisted, and
    the retried op persists the whole chain; a rename of ``/d1`` then
    leaves no ghost after a sync."""
    m = Masters(pkg, str(tmp_path)).start()
    try:
        run = _persist_fixture(m, op)
        fsm = m.fsm
        ufs = _root_ufs(m)
        real = ufs.mkdirs

        def mkdirs(path, *args, **kwargs):
            raise OSError(f"injected mkdirs failure for {path}")

        def states():
            return [fsm.get_status(p).persistence_state
                    for p in ("/d1", "/d1/d2")]

        monkeypatch.setattr(ufs, "mkdirs", mkdirs)
        if pkg == JAX:
            run()
            assert states() == ["PERSISTED", "PERSISTED"]
            assert fsm.get_status("/d1/d2/f").persistence_state == \
                "PERSISTED"
            return
        with pytest.raises(mod(pkg, "utils.exceptions").UnavailableError):
            run()
        assert states() == ["NOT_PERSISTED", "NOT_PERSISTED"]
        if op == "rename":
            assert fsm.get_status("/s/f").persistence_state == "PERSISTED"
            assert not fsm.exists("/d1/d2/f")
        else:
            assert fsm.get_status("/d1/d2/f").persistence_state != \
                "PERSISTED"
        monkeypatch.setattr(ufs, "mkdirs", real)
        run()
        assert states() == ["PERSISTED", "PERSISTED"]
        assert fsm.get_status("/d1/d2/f").persistence_state == "PERSISTED"
        uri = mod(pkg, "utils.uri").AlluxioURI("/d1/d2")
        assert os.path.isdir(fsm.mount_table.resolve(uri).ufs_path)
        fsm.rename("/d1", "/moved")
        names = {i.name for i in fsm.list_status("/", sync_interval_ms=0)}
        assert "d1" not in names and "moved" in names
        assert fsm.get_status("/moved/d2/f").persistence_state == \
            "PERSISTED"
    finally:
        m.stop()
