"""The port's tiered block store against the JAX package's: the same
seeded operations through both ``TieredBlockStore``s (MEM + SSD) give the
same block reports, the same listener events — eviction victims in the
same order — the same typed errors and the same bytes, for every
allocator and annotator; the port's counterparts of the JAX
``TestEvictionPins``; and the port's configuration keys against the JAX
catalog."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

KB = 1024
SESSION = 7
ALLOCATORS = ("MAX_FREE", "ROUND_ROBIN", "GREEDY")
ANNOTATORS = ("LRU", "LRFU")


def _pkg(prefix: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{prefix}.{name}")  # noqa: E731
    return SimpleNamespace(
        Allocator=mod("worker.allocator").Allocator,
        BlockAnnotator=mod("worker.annotator").BlockAnnotator,
        BlockMetadataManager=mod("worker.meta").BlockMetadataManager,
        TieredBlockStore=mod("worker.tiered_store").TieredBlockStore,
        errors=mod("utils.exceptions"))


JAX = _pkg("alluxio_tpu")
PORT = _pkg("alluxio_tpu_torch")


def make_store(pkg, root, *, allocator="MAX_FREE", annotator="LRU",
               mem_dirs=(10 * KB,), ssd_cap=100 * KB):
    meta = pkg.BlockMetadataManager()
    mem = meta.add_tier("MEM")
    for i, cap in enumerate(mem_dirs):
        mem.add_dir(str(root / f"mem{i}"), cap)
    if ssd_cap:
        meta.add_tier("SSD").add_dir(str(root / "ssd0"), ssd_cap)
    store = pkg.TieredBlockStore(meta, pkg.Allocator.create(allocator, meta),
                                 pkg.BlockAnnotator.create(annotator))
    store.events = []
    store.add_listener(lambda ev, bid: store.events.append((ev, bid)))
    return store


def put_block(store, block_id, data, tier="", pinned=False):
    store.create_block(SESSION, block_id, initial_bytes=len(data),
                       tier_alias=tier)
    with store.get_temp_writer(SESSION, block_id) as w:
        w.append(data)
    return store.commit_block(SESSION, block_id, pinned=pinned)


def outcome(fn, *args, **kwargs):
    """A call's result, or its error's class name (the part of a typed
    error both packages must agree on)."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - the class is the observation
        return ("error", type(e).__name__)


def contents(store):
    """block id -> (tier, dir index, bytes) of every committed block."""
    out = {}
    for tier, ids in store.block_report().items():
        for bid in ids:
            with store.get_reader(bid) as r:
                out[bid] = (tier, store.get_block_meta(bid).dir.index,
                            r.read(0, r.length))
    return out


def observe(store, log):
    cap, used = store.store_meta()
    return {"log": log, "events": store.events,
            "report": store.block_report(), "capacity": cap, "used": used,
            "contents": contents(store),
            "pinned": sorted(store.pinned_blocks),
            "prefetch_pinned": sorted(store.prefetch_pinned_blocks)}


# -- seeded operation scripts -------------------------------------------------
def seeded_script(pkg, root, allocator, annotator, seed, n_ops=160):
    """Random create/write/commit (some pinned, some growing past their
    reservation), read, remove, move, pin_block leases, prefetch pins and
    aborts over two MEM dirs and one SSD dir small enough that eviction
    and demotion run all the time."""
    store = make_store(pkg, root, allocator=allocator, annotator=annotator,
                       mem_dirs=(6 * KB, 5 * KB), ssd_cap=16 * KB)
    rng = np.random.default_rng(seed)
    log, leases, next_id = [], [], 1
    for step in range(n_ops):
        op = int(rng.integers(0, 9))
        known = sorted(b for ids in store.block_report().values()
                       for b in ids)
        pick = int(known[int(rng.integers(0, len(known)))]) if known \
            and rng.random() < 0.9 else 10_000 + step
        if op <= 2:  # write a block, sometimes beyond its reservation
            size = int(rng.integers(1, 5 * KB))
            data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            tier = ("", "MEM", "SSD")[int(rng.integers(0, 3))]
            hint = size if rng.random() < 0.7 else max(1, size // 2)
            bid, next_id = next_id, next_id + 1
            r = outcome(store.create_block, SESSION, bid,
                        initial_bytes=hint, tier_alias=tier)
            if r[0] == "ok":
                w = store.get_temp_writer(SESSION, bid)
                r = outcome(w.append, data)
                w.close()
                if r[0] == "ok" and rng.random() < 0.9:
                    r = outcome(lambda: store.commit_block(
                        SESSION, bid, pinned=bool(rng.random() < 0.2))
                        .tier_alias)
                else:
                    r = outcome(store.abort_block, SESSION, bid)
            log.append(("write", bid, tier, r))
        elif op == 3:
            def read(b=pick):
                with store.get_reader(b) as rd:
                    return rd.read(0, rd.length)
            log.append(("read", pick, outcome(read)))
        elif op in (4, 5) and pick in (b for b, _ in leases):
            # a leased block's removal would wait out the lease
            log.append(("leased", pick))
        elif op == 4:
            log.append(("remove", pick, outcome(store.remove_block, pick)))
        elif op == 5:
            tier = ("MEM", "SSD")[int(rng.integers(0, 2))]
            log.append(("move", pick, tier, outcome(
                lambda: store.move_block(pick, tier).tier_alias)))
        elif op == 6:  # a short-circuit lease held for a few ops
            r = outcome(store.pin_block, pick)
            if r[0] == "ok":
                leases.append((pick, r[1]))
                r = ("ok", None)
            log.append(("pin_block", pick, r))
        elif op == 7:
            log.append(("pin_prefetch", pick,
                        outcome(store.pin_prefetch, pick)))
        else:
            log.append(("unpin_prefetch", pick,
                        outcome(store.unpin_prefetch, pick)))
        if len(leases) > 2:
            leases.pop(0)[1].close()
    for _, lease in leases:
        lease.close()
    return observe(store, log)


# -- the JAX package's store scenarios (tests/test_tiered_store.py) ----------
def lifecycle(pkg, root, allocator, annotator):
    store = make_store(pkg, root, allocator=allocator, annotator=annotator)
    log = [put_block(store, 1, b"hello world", tier="MEM").tier_alias]
    with store.get_reader(1) as r:
        log += [r.read(0, 5), r.read(6, 5)]
    log.append(outcome(store.create_block, SESSION, 1, initial_bytes=1))
    store.create_block(SESSION, 2, initial_bytes=1000)
    with store.get_temp_writer(SESSION, 2) as w:
        w.append(b"tiny")  # commit reconciles the reservation
    store.commit_block(SESSION, 2)
    store.create_block(SESSION, 3, initial_bytes=KB)
    with store.get_temp_writer(SESSION, 3) as w:
        w.append(b"a" * (2 * KB))  # beyond the initial reservation
    log.append(store.commit_block(SESSION, 3).length)
    store.create_block(SESSION, 4, initial_bytes=KB)
    store.abort_block(SESSION, 4)
    store.create_block(SESSION, 5, initial_bytes=KB)
    store.create_block(SESSION + 1, 6, initial_bytes=KB)
    store.cleanup_session(SESSION)
    log.append(outcome(store.get_temp_writer, SESSION, 5))
    store.get_temp_writer(SESSION + 1, 6).close()
    store.abort_block(SESSION + 1, 6)
    store.remove_block(1)
    log.append(outcome(store.get_reader, 1))
    return observe(store, log)


def eviction(pkg, root, allocator, annotator):
    log = []
    store = make_store(pkg, root / "lru", allocator=allocator,
                       annotator=annotator, mem_dirs=(3 * KB,), ssd_cap=0)
    for i in range(3):
        put_block(store, i, bytes([i]) * KB, tier="MEM")
    store.get_reader(0).close()  # block 0 most recent
    put_block(store, 99, b"n" * KB, tier="MEM")
    log.append(observe(store, []))
    store = make_store(pkg, root / "demote", allocator=allocator,
                       annotator=annotator, mem_dirs=(2 * KB,))
    for bid, c in ((1, b"a"), (2, b"b"), (3, b"c")):
        put_block(store, bid, c * KB, tier="MEM")  # 3 demotes one
    log.append(observe(store, []))
    store = make_store(pkg, root / "pinned", allocator=allocator,
                       annotator=annotator, mem_dirs=(2 * KB,), ssd_cap=0)
    put_block(store, 1, b"a" * KB, tier="MEM", pinned=True)
    put_block(store, 2, b"b" * KB, tier="MEM", pinned=True)
    log.append(outcome(put_block, store, 3, b"c" * KB, tier="MEM"))
    store = make_store(pkg, root / "reading", allocator=allocator,
                       annotator=annotator, mem_dirs=(2 * KB,), ssd_cap=0)
    put_block(store, 1, b"a" * KB, tier="MEM")
    put_block(store, 2, b"b" * KB, tier="MEM")
    readers = [store.get_reader(1), store.get_reader(2)]
    log.append(outcome(put_block, store, 3, b"c" * KB, tier="MEM"))
    for r in readers:
        r.close()
    put_block(store, 4, b"d" * KB, tier="MEM")  # now evictable
    log.append(outcome(store.create_block, SESSION, 5,
                       initial_bytes=10 * KB, tier_alias="MEM"))
    log.append(observe(store, []))
    return log


def allocation(pkg, root, allocator, annotator):
    """Which dir each allocator picks over two MEM dirs (one half full)
    and an SSD below."""
    store = make_store(pkg, root, allocator=allocator, annotator=annotator,
                       mem_dirs=(4 * KB, 4 * KB, 2 * KB), ssd_cap=64 * KB)
    store.meta.get_tier("MEM").dirs[0].reserve(2 * KB)
    picks = []
    for bid in range(1, 12):
        meta = put_block(store, bid, b"z" * KB)
        picks.append((meta.tier_alias, meta.dir.index))
    return {"picks": picks, **observe(store, [])}


@pytest.mark.parametrize("annotator", ANNOTATORS)
@pytest.mark.parametrize("allocator", ALLOCATORS)
@pytest.mark.parametrize("scenario", ["lifecycle", "eviction", "allocation",
                                      "seed0", "seed1", "seed2"])
def test_store_matches_jax(tmp_path, scenario, allocator, annotator):
    if scenario.startswith("seed"):
        run = lambda pkg, root, a, n: seeded_script(  # noqa: E731
            pkg, root, a, n, int(scenario[4:]))
    else:
        run = globals()[scenario]
    want = run(JAX, tmp_path / "jax", allocator, annotator)
    got = run(PORT, tmp_path / "port", allocator, annotator)
    assert got == want


@pytest.mark.parametrize("allocator", ALLOCATORS)
def test_seeded_script_evicts(tmp_path, allocator):
    """The script is hard enough to mean something: it evicts, demotes,
    refuses for want of space, and vetoes pinned blocks."""
    got = seeded_script(PORT, tmp_path, allocator, "LRU", 0)
    kinds = {ev for ev, _ in got["events"]}
    assert {"committed", "evicted", "moved", "removed"} <= kinds
    errors = {r[-1][1] for r in got["log"]
              if isinstance(r[-1], tuple) and r[-1][0] == "error"}
    assert "WorkerOutOfSpaceError" in errors
    assert "BlockDoesNotExistError" in errors


# -- the port's counterparts of the JAX TestEvictionPins ---------------------
class TestEvictionPins:
    def _store(self, tmp_path, cap):
        return make_store(PORT, tmp_path, mem_dirs=(cap,), ssd_cap=0)

    def _put(self, store, bid, nbytes):
        store.create_block(1, bid, initial_bytes=nbytes)
        with store.get_temp_writer(1, bid) as w:
            w.append(b"x" * nbytes)
        return store.commit_block(1, bid)

    def test_prefetch_pinned_blocks_survive_eviction_pressure(self, tmp_path):
        store = self._store(tmp_path, cap=4096)
        self._put(store, 1, 1024)
        assert store.pin_prefetch(1)
        # pressure: fill the tier several times over; the LRU-coldest
        # block (1) is exactly the eviction candidate the pin must veto
        for bid in range(2, 10):
            self._put(store, bid, 1024)
        assert store.has_block(1)
        assert not store.pin_prefetch(999)  # absent block: not pinnable
        store.unpin_prefetch(1)
        for bid in range(10, 14):
            self._put(store, bid, 1024)
        assert not store.has_block(1)  # unpinned: evictable again

    def test_expired_pin_is_reclaimed(self, tmp_path):
        """TTL backstop: a client that died without unpinning must not
        leave blocks unevictable forever."""
        store = self._store(tmp_path, cap=4096)
        self._put(store, 1, 1024)
        assert store.pin_prefetch(1, ttl_s=0.0)  # expires immediately
        for bid in range(2, 10):
            self._put(store, bid, 1024)
        assert not store.has_block(1)  # expired pin did not veto
        assert 1 not in store.prefetch_pinned_blocks

    def test_remove_block_drops_the_pin(self, tmp_path):
        store = self._store(tmp_path, cap=4096)
        self._put(store, 1, 64)
        store.pin_prefetch(1)
        store.remove_block(1)
        assert 1 not in store.prefetch_pinned_blocks


# -- configuration keys -------------------------------------------------------
def _port_keys():
    from alluxio_tpu_torch.conf import Keys, Templates

    keys = [v for v in vars(Keys).values() if hasattr(v, "key_type")]
    keys += [t.format(i) for t in vars(Templates).values()
             if hasattr(t, "pattern") for i in range(3)]
    return keys


@pytest.mark.parametrize("key", _port_keys(), ids=lambda k: k.name)
def test_conf_key_matches_jax(key):
    from alluxio_tpu.conf.property_key import REGISTRY, Template

    want = REGISTRY.get(key.name)
    if want is None:  # a template member the JAX catalog mints on demand
        import re

        tmpl = Template.match(key.name)
        want = tmpl.format(*re.fullmatch(tmpl.regex, key.name).groups())
    assert (key.key_type.name, key.default, key.aliases, key.choices,
            key.scope.name, key.consistency.name) == (
        want.key_type.name, want.default, want.aliases, want.choices,
        want.scope.name, want.consistency.name)


def test_conf_parses_like_jax():
    from alluxio_tpu.conf import Configuration as JaxConfiguration
    from alluxio_tpu_torch.conf import Configuration, Keys, Templates

    values = {"atpu.worker.ramdisk.size": "2304MB",
              "atpu.worker.tieredstore.level0.dirs.quota": "1g,512mb",
              "atpu.worker.block.heartbeat.interval": "100ms",
              "atpu.user.rpc.retry.duration": "5s",
              "atpu.worker.allocator.class": "greedy"}
    mine, theirs = Configuration(values, load_env=False), \
        JaxConfiguration(values, load_env=False)
    for key in (Keys.WORKER_RAMDISK_SIZE, Keys.WORKER_ALLOCATOR_CLASS,
                Keys.WORKER_BLOCK_HEARTBEAT_INTERVAL,
                Keys.USER_RPC_RETRY_MAX_DURATION,
                Templates.WORKER_TIER_DIRS_QUOTA.format(0)):
        assert mine.get(key) == theirs.get(key.name)


# -- the async cache's queue --------------------------------------------------
@pytest.mark.parametrize("prioritize", [False, True])
def test_priority_queue_drains_like_jax(prioritize):
    """The same seeded puts (with QoS classes) drain in the same order
    from both packages' ``PriorityTaskQueue``: FIFO with QoS off, by
    class then arrival with it on; a full queue refuses alike."""
    import queue

    from alluxio_tpu import qos as jax_qos
    from alluxio_tpu_torch import qos

    rng = np.random.default_rng(5)
    classes = rng.choice([qos.ON_DEMAND, qos.ASYNC_FILL, qos.PREFETCH], 40)
    names = [qos.PRIORITY_NAMES[int(c)] for c in classes]
    assert [qos.priority_from_name(n) for n in names] == \
        [jax_qos.priority_from_name(n) for n in names]
    orders = []
    for mod in (jax_qos, qos):
        q = mod.PriorityTaskQueue(32, prioritize=prioritize)
        refused = 0
        for i, c in enumerate(classes):
            try:
                q.put_nowait(i, int(c))
            except queue.Full:
                refused += 1
        got = []
        while q.qsize():
            got.append(q.get(timeout=0))
            q.task_done()
        orders.append((got, refused, q.unfinished_tasks))
    assert orders[1] == orders[0]
    assert orders[0][1] == 8
    if not prioritize:
        assert orders[0][0] == list(range(32))
