"""The port's disk-backed metastores against the JAX package's, on the CPU.

- The LSM store's codecs, its write-ahead log and its sorted-run files
  come out byte for byte equal from the same seeded input, and each
  package reads the other's log and runs.
- SQLITE, LSM, CACHING and CACHING:LSM give equal lookups, edges and
  counts under the same seeded put/add_child/remove sequence.
- An LSM directory built with the compactor off and explicit flushes and
  compactions holds the same files in both packages, and each opens the
  other's.
- An LSM checkpoint taken by either package restores into the other's
  inode tree, into LSM and into the other kinds.
- The port's copies of the JAX metastore tests (``test_metastore_lsm.py``
  and ``test_metadata_plane.py::test_non_heap_metastore_serves_namespace``)
  and the compactor thread's own path, which stops in ``close()``.
"""

import os
import random
import shutil
import threading

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.testutils.torch_master import PACKAGES, mod  # noqa: E402

JAX, PORT = PACKAGES
BLOCK_SIZE = 1024
KINDS = ("SQLITE", "LSM", "CACHING", "CACHING:LSM")


def _rng(seed):
    return np.random.default_rng(seed)


def _names(rng, n):
    # multibyte names too: edge keys are UTF-8 and sort bytewise
    alphabet = list("abcxyz09_-") + ["é", "日"]
    return ["".join(rng.choice(alphabet, size=int(rng.integers(1, 9))))
            for _ in range(n)]


def _files(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


# -- codecs, log and runs -----------------------------------------------------
@pytest.mark.parametrize("seed", (0, 1))
def test_encoding_is_byte_identical(seed):
    rng = _rng(seed)
    ids = [int(x) for x in rng.integers(0, 2 ** 63, 50, dtype=np.int64)]
    names = _names(rng, 50)
    out = []
    for pkg in PACKAGES:
        enc = mod(pkg, "master.metastore.encoding")
        keys = [enc.inode_key(i) for i in ids]
        edges = [enc.edge_key(i, n) for i, n in zip(ids, names)]
        out.append((
            keys, [enc.decode_inode_key(k) for k in keys],
            edges, [enc.decode_edge_key(k) for k in edges],
            [enc.edge_prefix(i) for i in ids],
            [enc.edge_value(i) for i in ids],
            [enc.decode_edge_value(enc.edge_value(i)) for i in ids],
            enc.INODE_PREFIX, enc.EDGE_PREFIX))
    assert out[1] == out[0]
    assert out[0][1] == ids and [i for i, _ in out[0][3]] == ids


def _records(seed, n=80):
    rng = _rng(seed)
    out = []
    for name in _names(rng, n):
        key = name.encode()
        value = None if rng.random() < 0.2 else \
            rng.integers(0, 256, int(rng.integers(0, 40)),
                         dtype=np.uint8).tobytes()
        out.append((key, value))
    return out


@pytest.mark.parametrize("seed", (0, 1))
def test_wal_is_byte_identical_and_replays_across(tmp_path, seed):
    recs = _records(seed)
    paths = {}
    for pkg in PACKAGES:
        wal = mod(pkg, "master.metastore.wal").WriteAheadLog(
            str(tmp_path / f"{pkg}.log"))
        for k, v in recs:
            wal.append(k, v)
        wal.close()
        paths[pkg] = wal.path
    blobs = [open(paths[p], "rb").read() for p in PACKAGES]
    assert blobs[1] == blobs[0]
    cut = int(_rng(seed).integers(1, len(blobs[0])))
    for reader, writer in ((JAX, PORT), (PORT, JAX)):
        log = mod(reader, "master.metastore.wal").WriteAheadLog
        assert list(log(paths[writer]).replay()) == recs
        torn = str(tmp_path / f"{writer}-torn.log")
        with open(torn, "wb") as f:
            f.write(blobs[0][:cut])
        replayed = list(log(torn).replay())
        assert replayed == recs[:len(replayed)]
    truncated = []
    for pkg in PACKAGES:
        wal = mod(pkg, "master.metastore.wal").WriteAheadLog(paths[pkg])
        wal.truncate()
        wal.append(b"k", b"v")
        wal.close()
        truncated.append(open(paths[pkg], "rb").read())
    assert truncated[1] == truncated[0]


@pytest.mark.parametrize("seed", (0, 1))
def test_sorted_run_is_byte_identical_and_reads_across(tmp_path, seed):
    recs = sorted(dict(_records(seed, 300)).items())
    paths = {}
    for pkg in PACKAGES:
        sst = mod(pkg, "master.metastore.sstable")
        paths[pkg] = str(tmp_path / f"{pkg}.sst")
        sst.write_run(paths[pkg], iter(recs), bits_per_key=8)
    assert open(paths[PORT], "rb").read() == open(paths[JAX], "rb").read()
    probes = [k for k, _ in recs[::7]] + [b"absent", b"", b"\xff"]
    seen = []
    for reader, writer in ((JAX, PORT), (PORT, JAX)):
        sst = mod(reader, "master.metastore.sstable")
        run = sst.SortedRun(paths[writer])
        try:
            got = [run.get(k) for k in probes]
            got = ["MISSING" if g is sst.MISSING else g for g in got]
            seen.append((run.count, got, list(run.iter_from()),
                         list(run.iter_from(recs[len(recs) // 2][0]))))
        finally:
            run.close()
    assert seen[1] == seen[0]
    assert seen[0][2] == recs and seen[0][1][:-3] == [v for _, v in
                                                      recs[::7]]
    blooms = []
    for pkg in PACKAGES:
        bloom = mod(pkg, "master.metastore.sstable").BloomFilter.sized_for(
            len(recs), 10)
        for k, _ in recs:
            bloom.add(k)
        blooms.append((bloom.bits, bloom.k, bytes(bloom.data),
                       [list(bloom._probes(k)) for k in probes]))
    assert blooms[1] == blooms[0]


# -- the stores, seeded ------------------------------------------------------
def _inode(pkg, rng, iid, parent):
    inode = mod(pkg, "master.inode").Inode
    return inode(id=iid, parent_id=parent, name=f"n{iid}",
                 is_directory=bool(rng.random() < 0.3),
                 length=int(rng.integers(0, 1 << 20)),
                 creation_time_ms=int(rng.integers(0, 1 << 40)),
                 xattr={"k": str(int(rng.integers(0, 9)))})


def _store_script(store, pkg, seed, n_ops=400):
    """A seeded sequence of put, add_child, remove, remove_child and get
    over a small id range (hits, misses and overwrites on purpose);
    returns what the gets saw."""
    rng = _rng(seed)
    seen = []
    for _ in range(n_ops):
        op = int(rng.integers(6))
        iid = int(rng.integers(1, 60))
        parent = int(rng.integers(0, 6))
        name = f"c{int(rng.integers(0, 25))}"
        if op in (0, 1):
            store.put(_inode(pkg, rng, iid, parent))
        elif op == 2:
            store.add_child(parent, name, iid)
        elif op == 3:
            store.remove(iid)
        elif op == 4:
            store.remove_child(parent, name)
        else:
            got = store.get(iid)
            seen.append(None if got is None else got.to_wire_dict())
            seen.append(store.get_child_id(parent, name))
    return seen


def _observe(store):
    return {
        "inodes": sorted((i.id, sorted(i.to_wire_dict().items()))
                         for i in store.iter_inodes()),
        "ids": sorted(store.all_ids()),
        "edges": [list(store.iter_edges(p)) for p in range(6)],
        "after": [list(store.iter_edges(p, start_after="c1"))
                  for p in range(6)],
        "names": [store.child_names(p) for p in range(6)],
        "counts": [store.child_count(p) for p in range(6)],
        "has": [store.has_children(p) for p in range(6)],
        "size": store.estimated_size(),
    }


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("kind", KINDS)
def test_backend_matches_jax(tmp_path, kind, seed):
    out = []
    for pkg in PACKAGES:
        create = mod(pkg, "master.metastore").create_inode_store
        store = create(kind, str(tmp_path / pkg), cache_size=8,
                       lsm_options={"memtable_bytes": 4096,
                                    "compaction": False})
        try:
            seen = _store_script(store, pkg, seed)
            if hasattr(store, "compact_now"):
                store.compact_now()
            out.append((type(store).__name__, seen, _observe(store),
                        store.stats()["kind"]))
        finally:
            store.close()
    assert out[1] == out[0]


def _build_lsm(pkg, directory, seed):
    """A deterministic LSM directory: compactor off, a memtable too large
    to flush by itself, explicit seals and one explicit compaction."""
    store = mod(pkg, "master.metastore.lsm").LsmInodeStore(
        str(directory), memtable_bytes=1 << 30, max_runs_per_tier=3,
        compaction=False)
    rng = _rng(seed)
    for step in range(5):
        for _ in range(60):
            iid = int(rng.integers(1, 200))
            if rng.random() < 0.15:
                store.remove(iid)
            else:
                store.put(_inode(pkg, rng, iid, int(rng.integers(0, 5))))
                store.add_child(int(rng.integers(0, 5)),
                                f"e{int(rng.integers(0, 40))}", iid)
        store.seal()
        if step == 3:
            store.compact_now()
    for _ in range(30):  # an un-sealed tail the WAL carries
        iid = int(rng.integers(1, 200))
        store.put(_inode(pkg, rng, iid, 0))
    store.flush()
    return store


@pytest.mark.parametrize("seed", (0, 3))
def test_lsm_directory_is_byte_identical_and_opens_across(tmp_path, seed):
    stores = {p: _build_lsm(p, tmp_path / p, seed) for p in PACKAGES}
    try:
        stats = [stores[p].stats() for p in PACKAGES]
        assert stats[1] == stats[0]
        assert stats[0]["compactions"] == 1 and stats[0]["runs"] > 1
        files = [_files(tmp_path / p) for p in PACKAGES]
        assert files[1] == files[0]
        assert "wal.log" in files[0] and files[0]["wal.log"]
        views = [_observe(stores[p]) for p in PACKAGES]
        assert views[1] == views[0]
    finally:
        # abandon without close(): close() seals the WAL tail, and the
        # other package must replay it
        for s in stores.values():
            s._wal.close()
            for r in s._runs:
                r.close()
    for reader, writer in ((JAX, PORT), (PORT, JAX)):
        copy = tmp_path / f"{writer}-read-by-{reader}"
        shutil.copytree(tmp_path / writer, copy)
        store = mod(reader, "master.metastore.lsm").LsmInodeStore(
            str(copy), compaction=False)
        try:
            assert store.recovered_wal_records == 30
            assert _observe(store) == views[0]
        finally:
            store.close()


# -- namespaces through the file master ---------------------------------------
def _make_fsm(pkg, store=None, journal=None, **kw):
    journal = journal or mod(pkg, "journal").NoopJournalSystem()
    bm = mod(pkg, "master.block_master").BlockMaster(journal)
    m = mod(pkg, "master.file_master").FileSystemMaster(
        bm, journal, inode_store=store, default_block_size=BLOCK_SIZE, **kw)
    m.start(None)
    return m


def _walk(fsm, path="/"):
    """Deterministic full-tree walk: sorted (path, is_dir, length)."""
    out = []
    stack = [path]
    while stack:
        p = stack.pop()
        for info in sorted(fsm.list_status(p), key=lambda i: i.path):
            out.append((info.path, info.folder, info.length))
            if info.folder:
                stack.append(info.path)
    return out


def _apply_seeded_ops(fsm, pkg, seed: int, n_ops: int):
    """The JAX test's op stream: create/mkdir/delete/rename/stat over a
    small path alphabet, collisions and misses included."""
    exc = mod(pkg, "utils.exceptions")
    errors = (exc.FileAlreadyExistsError, exc.FileDoesNotExistError,
              exc.InvalidPathError)
    rng = random.Random(seed)
    dirs = [f"/d{i}" for i in range(4)]
    outcomes = []
    for _ in range(n_ops):
        op = rng.randrange(5)
        d = rng.choice(dirs)
        name = f"x{rng.randrange(12)}"
        try:
            if op == 0:
                fsm.create_file(f"{d}/{name}", recursive=True)
                outcomes.append(("create", d, name, "ok"))
            elif op == 1:
                fsm.create_directory(f"{d}/sub{rng.randrange(3)}",
                                     recursive=True, allow_exists=True)
                outcomes.append(("mkdir", d, name, "ok"))
            elif op == 2:
                fsm.delete(f"{d}/{name}")
                outcomes.append(("delete", d, name, "ok"))
            elif op == 3:
                fsm.rename(f"{d}/{name}",
                           f"{rng.choice(dirs)}/y{rng.randrange(12)}")
                outcomes.append(("rename", d, name, "ok"))
            else:
                fsm.get_status(f"{d}/{name}")
                outcomes.append(("stat", d, name, "ok"))
        except errors as e:
            outcomes.append(("err", d, name, type(e).__name__))
    return outcomes


def _lsm_snapshot(pkg, directory, seed):
    create = mod(pkg, "master.metastore").create_inode_store
    store = create("LSM", str(directory), cache_size=16,
                   lsm_options={"memtable_bytes": 4096})
    fsm = _make_fsm(pkg, store)
    try:
        _apply_seeded_ops(fsm, pkg, seed, 80)
        before = _walk(fsm)
        snap = fsm.inode_tree.snapshot()
    finally:
        fsm.stop()
    assert snap["store_state"]["format"] == "lsm-runs"
    return before, snap


@pytest.mark.parametrize("kind", ("LSM", "HEAP", "SQLITE", "CACHING"))
@pytest.mark.parametrize("src,dst", ((JAX, PORT), (PORT, JAX),
                                     (PORT, PORT)))
def test_lsm_checkpoint_restores_across_packages_and_kinds(
        tmp_path, src, dst, kind):
    """Mirrors ``test_lsm_snapshot_restores_cross_kind``: a checkpoint
    taken by either package hydrates the other's tree, into LSM (native)
    and into a kind with no native format (through a throwaway LSM
    reader)."""
    before, snap = _lsm_snapshot(src, tmp_path / "src", 23)
    jax_before, _ = _lsm_snapshot(JAX, tmp_path / "ref", 23)
    assert before == jax_before
    create = mod(dst, "master.metastore").create_inode_store
    fsm = _make_fsm(dst, create(kind, str(tmp_path / "dst"), cache_size=16))
    try:
        fsm.inode_tree.restore(snap)
        assert _walk(fsm) == before
        fsm.create_file("/after/restore", recursive=True)
        assert fsm.exists("/after/restore")
    finally:
        fsm.stop()


# -- the port's copies of the JAX metastore tests ------------------------------
@pytest.mark.parametrize("seed", (7, 41))
def test_seeded_ops_equivalent(tmp_path, seed):
    m = mod(PORT, "master.metastore")
    stores = {
        "HEAP": m.HeapInodeStore(),
        "SQLITE": m.SqliteInodeStore(str(tmp_path / "sq")),
        "LSM": m.create_inode_store("LSM", str(tmp_path / "lsm"),
                                    cache_size=16,
                                    lsm_options={"memtable_bytes": 4096}),
    }
    walks, versions, outcomes = {}, {}, {}
    for kind, store in stores.items():
        fsm = _make_fsm(PORT, store)
        try:
            outcomes[kind] = _apply_seeded_ops(fsm, PORT, seed, 200)
            walks[kind] = _walk(fsm)
            versions[kind] = fsm.invalidations.version
        finally:
            fsm.stop()
    assert outcomes["HEAP"] == outcomes["SQLITE"] == outcomes["LSM"]
    assert walks["HEAP"] == walks["SQLITE"] == walks["LSM"]
    assert versions["HEAP"] == versions["SQLITE"] == versions["LSM"]


def test_lsm_journal_replay_restart(tmp_path):
    """Kill the master, replay the journal into a fresh LSM store: the
    namespace comes back identical."""
    def boot(journal_dir, store_dir):
        journal = mod(PORT, "journal").LocalJournalSystem(str(journal_dir))
        journal.start()
        store = mod(PORT, "master.metastore").create_inode_store(
            "LSM", str(store_dir), cache_size=16)
        bm = mod(PORT, "master.block_master").BlockMaster(journal)
        fsm = mod(PORT, "master.file_master").FileSystemMaster(
            bm, journal, inode_store=store, default_block_size=BLOCK_SIZE)
        journal.gain_primacy()
        fsm.start(None)
        return journal, fsm

    journal, fsm = boot(tmp_path / "j", tmp_path / "lsm1")
    _apply_seeded_ops(fsm, PORT, 13, 120)
    before = _walk(fsm)
    fsm.stop()
    journal.stop()

    journal2, fsm2 = boot(tmp_path / "j", tmp_path / "lsm2")
    try:
        assert _walk(fsm2) == before
    finally:
        fsm2.stop()
        journal2.stop()


def _lsm_store(base, **kw):
    return mod(PORT, "master.metastore.lsm").LsmInodeStore(str(base), **kw)


def _inode_named(iid, name):
    return mod(PORT, "master.inode").Inode(id=iid, parent_id=0, name=name)


def _build_wal_only(base, n=60):
    """n sequenced single-record ops, memtable never flushed: the WAL
    alone carries the state. Returns per-prefix id->name snapshots."""
    store = _lsm_store(base, memtable_bytes=1 << 30, compaction=False)
    states = [dict()]
    cur = {}
    rng = random.Random(5)
    for i in range(n):
        iid = rng.randrange(1, 16)
        if iid in cur and rng.random() < 0.3:
            store.remove(iid)
            cur.pop(iid)
        else:
            store.put(_inode_named(iid, f"n{i}"))
            cur[iid] = f"n{i}"
        states.append(dict(cur))
    store._wal.flush()
    wal_path = store._wal.path
    # abandon without close(): close would seal the memtable into a run
    # and truncate the WAL
    store._wal.close()
    for r in store._runs:
        r.close()
    return states, wal_path


def test_wal_truncation_recovers_a_prefix(tmp_path):
    base = tmp_path / "lsm"
    states, wal_path = _build_wal_only(base)
    size = os.path.getsize(wal_path)
    assert size > 0
    rng = random.Random(99)
    cuts = [0, size] + [rng.randrange(1, size) for _ in range(6)]
    for i, cut in enumerate(cuts):
        crashed = tmp_path / f"crash{i}"
        shutil.copytree(base, crashed)
        with open(crashed / os.path.basename(wal_path), "r+b") as f:
            f.truncate(cut)
        store = _lsm_store(crashed, compaction=False)
        try:
            recovered = {ino.id: ino.name for ino in store.iter_inodes()}
            assert recovered in states, \
                f"cut at {cut}/{size} recovered no op-prefix"
        finally:
            store.close()


def test_clean_restart_is_lossless(tmp_path):
    states, _ = _build_wal_only(tmp_path / "lsm", n=40)
    store = _lsm_store(tmp_path / "lsm", compaction=False)
    try:
        assert {i.id: i.name for i in store.iter_inodes()} == states[-1]
        assert store.stats()["inodes"] == len(states[-1])
    finally:
        store.close()


def test_flush_and_compaction_preserve_state(tmp_path):
    store = _lsm_store(tmp_path / "lsm", memtable_bytes=2048,
                       compaction=False)
    try:
        expect = {}
        for i in range(1, 300):
            store.put(_inode_named(i, f"f{i:04d}"))
            expect[i] = f"f{i:04d}"
            if i % 7 == 0:
                store.remove(i)
                expect.pop(i)
        assert store.stats()["runs"] > 1
        store.compact_now()
        assert {i.id: i.name for i in store.iter_inodes()} == expect
        assert store.stats()["inodes"] == len(expect)
    finally:
        store.close()


def test_compactor_thread_compacts_and_stops_on_close(tmp_path):
    """The background compactor's own path (the parity tests run with it
    off): it merges runs while writers go on, and ``close()`` stops it."""
    store = _lsm_store(tmp_path / "lsm", memtable_bytes=4096,
                       max_runs_per_tier=2, compaction_poll_s=0.01)
    try:
        expect = {}
        for i in range(1, 1500):
            store.put(_inode_named(i, f"g{i:05d}"))
            expect[i] = f"g{i:05d}"
            store.add_child(0, f"g{i:05d}", i)
        deadline = threading.Event()
        for _ in range(500):
            if store.stats()["compactions"] > 0:
                break
            deadline.wait(0.01)
        assert store.stats()["compactions"] > 0
        assert {i.id: i.name for i in store.iter_inodes()} == expect
        assert [n for n, _ in store.iter_edges(0)] == sorted(expect.values())
        thread = store._compactor
        assert thread is not None and thread.is_alive()
    finally:
        store.close()
    assert not thread.is_alive()
    assert not any(t.name == "lsm-compaction" and t is thread
                   for t in threading.enumerate())
    reopened = _lsm_store(tmp_path / "lsm", compaction=False)
    try:
        assert reopened.recovered_wal_records == 0
        assert reopened.estimated_size() == len(expect)
    finally:
        reopened.close()


def test_heap_snapshot_format_unchanged():
    fsm = _make_fsm(PORT)
    try:
        fsm.create_file("/snap/f", recursive=True)
        snap = fsm.inode_tree.snapshot()
        assert set(snap.keys()) == {"root_id", "inodes",
                                    "invalidation_version"}
        assert isinstance(snap["inodes"], list)
    finally:
        fsm.stop()


def test_lsm_snapshot_restores_into_lsm(tmp_path):
    before, snap = _lsm_snapshot(PORT, tmp_path / "a", 3)
    store2 = mod(PORT, "master.metastore").create_inode_store(
        "LSM", str(tmp_path / "b"), cache_size=16)
    fsm2 = _make_fsm(PORT, store2)
    try:
        fsm2.inode_tree.restore(snap)
        assert _walk(fsm2) == before
    finally:
        fsm2.stop()


def test_concurrent_sibling_creates_one_hot_dir():
    fsm = _make_fsm(PORT)
    try:
        fsm.create_directory("/hot")
        errs = []

        def worker(t):
            try:
                for i in range(20):
                    fsm.create_file(f"/hot/t{t}-{i}")
            except Exception as e:  # noqa: BLE001 surfaced below
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errs
        assert len(fsm.list_status("/hot")) == 80
    finally:
        fsm.stop()


def test_duplicate_create_excluded_by_edge_lock():
    exists = mod(PORT, "utils.exceptions").FileAlreadyExistsError
    fsm = _make_fsm(PORT)
    try:
        fsm.create_directory("/dup")
        results = []
        barrier = threading.Barrier(2)

        def racer():
            barrier.wait()
            try:
                fsm.create_file("/dup/same")
                results.append("ok")
            except exists:
                results.append("exists")

        threads = [threading.Thread(target=racer) for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert sorted(results) == ["exists", "ok"]
        assert len(fsm.list_status("/dup")) == 1
    finally:
        fsm.stop()


def test_edge_locking_off_still_correct():
    fsm = _make_fsm(PORT, edge_locking=False)
    try:
        assert not fsm.inode_tree.edge_locking
        fsm.create_file("/a/b/f", recursive=True)
        fsm.rename("/a/b/f", "/a/b/g")
        fsm.delete("/a/b/g")
        assert fsm.list_status("/a/b") == []
    finally:
        fsm.stop()


def test_unknown_kind_is_typed_error(tmp_path):
    m = mod(PORT, "master.metastore")
    with pytest.raises(mod(PORT, "utils.exceptions").InvalidArgumentError):
        m.create_inode_store("ROCKSDB", str(tmp_path))


def test_caching_composes_over_lsm(tmp_path):
    m = mod(PORT, "master.metastore")
    store = m.create_inode_store("CACHING:LSM", str(tmp_path), cache_size=4)
    try:
        assert isinstance(store, m.CachingInodeStore)
        assert isinstance(store.backing, m.LsmInodeStore)
        assert store.stats()["kind"] == "CACHING:LSM"
    finally:
        store.close()


def test_list_status_page_cursor_walk(tmp_path):
    store = mod(PORT, "master.metastore").create_inode_store(
        "LSM", str(tmp_path), cache_size=8)
    fsm = _make_fsm(PORT, store)
    try:
        for i in range(25):
            fsm.create_file(f"/big/f{i:03d}", recursive=True)
        seen, cursor, pages = [], None, 0
        while True:
            page = fsm.list_status_page("/big", start_after=cursor,
                                        limit=10)
            assert page["md_version"] >= 0
            seen.extend(info["name"] for info in page["infos"])
            pages += 1
            if page["next"] is None:
                break
            cursor = page["next"]
        assert pages == 3
        assert seen == sorted(f"f{i:03d}" for i in range(25))
    finally:
        fsm.stop()


@pytest.mark.parametrize("kind", ["SQLITE", "CACHING", "LSM"])
def test_non_heap_metastore_serves_namespace(tmp_path, kind):
    m = mod(PORT, "master.metastore")
    store = m.create_inode_store(kind, str(tmp_path / "ms"), cache_size=8)
    assert isinstance(store, (m.SqliteInodeStore, m.CachingInodeStore))
    fsm = _make_fsm(PORT, store)
    try:
        for i in range(20):  # spill past the CACHING bound of 8
            fsm.create_file(f"/ms/f{i}", recursive=True)
        names = sorted(i.name for i in fsm.list_status("/ms"))
        assert names == sorted(f"f{i}" for i in range(20))
        fsm.rename("/ms/f0", "/ms/zz")
        assert fsm.exists("/ms/zz")
    finally:
        fsm.stop()


def test_master_process_passes_metastore_options(tmp_path):
    """``MasterProcess`` builds its store from the four keys, as JAX's
    does: LSM is caching-wrapped with the configured bound, and the LSM
    options reach the store."""
    conf_mod = mod(PORT, "conf")
    conf = conf_mod.Configuration(load_env=False)
    keys = conf_mod.Keys
    conf.set(keys.MASTER_JOURNAL_FOLDER, str(tmp_path / "journal"))
    conf.set(keys.MASTER_METASTORE, "LSM")
    conf.set(keys.MASTER_METASTORE_DIR, str(tmp_path / "ms"))
    conf.set(keys.MASTER_METASTORE_INODE_CACHE_MAX_SIZE, 32)
    conf.set(keys.MASTER_METASTORE_LSM_MEMTABLE_BYTES, "64KB")
    conf.set(keys.MASTER_METASTORE_LSM_COMPACTION_TRIGGER, 6)
    process = mod(PORT, "master.process").MasterProcess(
        conf, root_ufs_uri=str(tmp_path / "ufs"))
    store = process.fs_master.inode_tree._store
    try:
        m = mod(PORT, "master.metastore")
        assert isinstance(store, m.CachingInodeStore)
        assert isinstance(store.backing, m.LsmInodeStore)
        assert store._max == 32
        assert store.backing._memtable_limit == 64 << 10
        assert store.backing._max_runs_per_tier == 6
    finally:
        store.close()
