"""The port's clairvoyant prefetch loop (``alluxio_tpu_torch.prefetch``)
on the CPU: the same oracle and scheduler inputs through both packages
give the same block sequences, placements, outcomes and stats (exactly),
and the port's versions of ``tests/test_prefetch_service.py``'s cases
that need no worker-side module, the end-to-end ones running the port's
service and loader over the JAX package's LocalCluster."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu import prefetch as jp  # noqa: E402
from alluxio_tpu.minicluster import LocalCluster  # noqa: E402
from alluxio_tpu_torch.prefetch import (  # noqa: E402
    AccessOracle, BlockRef, DatasetManifest, PrefetchScheduler,
    PrefetchService, TIER_DRAM, TIER_HBM,
)
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

BLOCK = 64 * 1024


def make_manifest(n=10, length=10, pkg=None):
    ref, manifest = (jp.BlockRef, jp.DatasetManifest) if pkg == "jax" \
        else (BlockRef, DatasetManifest)
    return manifest(blocks=tuple(
        ref(path=f"/data/{i % 3}", block_index=i, block_id=100 + i,
            length=length + (i % 4)) for i in range(n)))


def _ids(seq):
    return [r.block_id for r in seq]


def _window(win):
    return [(s, r.block_id) for s, r in win]


# -- parity with the JAX package --------------------------------------------
class TestParity:
    @pytest.mark.parametrize("seed", [0, 7, 20261016])
    @pytest.mark.parametrize("num_hosts,host_index",
                             [(1, 0), (3, 0), (3, 2), (4, 1)])
    def test_oracle_sequences_and_windows_match_jax(self, seed, num_hosts,
                                                    host_index):
        mine = AccessOracle(make_manifest(37), seed, num_hosts=num_hosts,
                            host_index=host_index)
        ref = jp.AccessOracle(make_manifest(37, pkg="jax"), seed,
                              num_hosts=num_hosts, host_index=host_index)
        assert mine.epoch_len() == ref.epoch_len()
        for epoch in range(4):
            assert _ids(mine.epoch_sequence(epoch)) == \
                _ids(ref.epoch_sequence(epoch))
        n = mine.epoch_len()
        # within an epoch, across one boundary, across several
        for epoch, pos, k in ((0, 0, 5), (1, n - 2, 5), (2, 3, 3 * n + 1)):
            assert _window(mine.window(epoch, pos, k)) == \
                _window(ref.window(epoch, pos, k))
            assert mine.global_seq(epoch, pos) == ref.global_seq(epoch, pos)

    @pytest.mark.parametrize("lookahead,budget,hbm_fraction,backoff", [
        (10, 35, 0.0, 0.0), (6, 60, 0.3, 0.0), (4, 100, 1.0, 60.0),
        (12, 40, 0.5, 60.0)])
    def test_scheduler_script_matches_jax(self, lookahead, budget,
                                          hbm_fraction, backoff):
        """One seeded script of plan/on_loaded/on_load_failed/on_consume/
        begin_epoch/on_evicted calls through both schedulers: the same
        actions, outcomes and stats() at every step."""
        kw = dict(lookahead_blocks=lookahead, budget_bytes=budget,
                  hbm_fraction=hbm_fraction, retry_backoff_s=backoff)
        mine_o = AccessOracle(make_manifest(12), seed=5)
        ref_o = jp.AccessOracle(make_manifest(12, pkg="jax"), seed=5)
        mine = PrefetchScheduler(mine_o, **kw)
        ref = jp.PrefetchScheduler(ref_o, **kw)
        rng = np.random.default_rng(lookahead * 1000 + budget)
        inflight, ready, gen = [], [], None
        for _ in range(400):
            op = rng.choice(["plan", "loaded", "failed", "consume",
                             "epoch", "evicted"],
                            p=[.25, .2, .05, .35, .05, .1])
            if op == "plan":
                got, want = mine.plan(), ref.plan()
                assert [(a.ref.block_id, a.tier, a.deadline_seq)
                        for a in got] == \
                    [(a.ref.block_id, a.tier, a.deadline_seq) for a in want]
                inflight += [a.ref.block_id for a in got]
            elif op in ("loaded", "failed") and inflight:
                bid = inflight.pop(int(rng.integers(len(inflight))))
                if op == "loaded":
                    mine.on_loaded(bid)
                    ref.on_loaded(bid)
                    ready.append(bid)
                else:
                    mine.on_load_failed(bid)
                    ref.on_load_failed(bid)
            elif op == "evicted" and ready:
                bid = ready.pop(int(rng.integers(len(ready))))
                mine.on_evicted(bid)
                ref.on_evicted(bid)
            elif op == "consume":
                epoch, pos = mine.cursor()
                assert ref.cursor() == (epoch, pos)
                i = mine_o.epoch_sequence(epoch)[pos].block_index
                hint = bool(rng.random() < 0.1)
                stale = gen is not None and rng.random() < 0.1
                g = (gen - 1) if stale else gen
                assert mine.on_consume(
                    mine_o.manifest.blocks[i], resident_hint=hint,
                    generation=g) == ref.on_consume(
                        ref_o.manifest.blocks[i], resident_hint=hint,
                        generation=g)
            elif op == "epoch":
                e = int(rng.integers(0, 3))
                gen = mine.begin_epoch(e)
                assert ref.begin_epoch(e) == gen
            assert mine.stats() == ref.stats()
            assert mine.ready_count() == ref.ready_count()
            assert mine.inflight_count() == ref.inflight_count()
            for tier in (TIER_HBM, TIER_DRAM):
                assert mine.held_bytes(tier) == ref.held_bytes(tier)
        st = mine.stats()
        assert st["hits"] and st["misses"]  # the script reached both

    def test_manifest_from_the_same_fs_matches_jax(self, tmp_path):
        with LocalCluster(str(tmp_path), num_workers=1,
                          block_size=BLOCK) as c:
            fs = c.file_system()
            fs.write_all("/m/a", b"a" * (2 * BLOCK + 7))
            fs.write_all("/m/b", b"b" * BLOCK)
            mine = DatasetManifest.from_fs(fs, ["/m/a", "/m/b"])
            ref = jp.DatasetManifest.from_fs(fs, ["/m/a", "/m/b"])
            assert [dataclasses.asdict(b) for b in mine.blocks] == \
                [dataclasses.asdict(b) for b in ref.blocks]
            assert len(mine) == 4 and mine.total_bytes == ref.total_bytes
            assert [p for p, _ in mine.file_infos] == ["/m/a", "/m/b"]


# -- the port's versions of tests/test_prefetch_service.py ------------------
class TestOracle:
    def test_fixed_seed_is_deterministic(self):
        m = make_manifest()
        a = AccessOracle(m, seed=7)
        b = AccessOracle(m, seed=7)
        for epoch in (0, 1, 5):
            assert _ids(a.epoch_sequence(epoch)) == \
                _ids(b.epoch_sequence(epoch))

    def test_epochs_and_seeds_differ(self):
        m = make_manifest(32)
        o = AccessOracle(m, seed=7)
        e0 = _ids(o.epoch_sequence(0))
        e1 = _ids(o.epoch_sequence(1))
        assert sorted(e0) == sorted(e1)  # same corpus
        assert e0 != e1                  # reshuffled
        assert e0 != _ids(AccessOracle(m, seed=8).epoch_sequence(0))

    def test_host_shards_partition_the_epoch(self):
        m = make_manifest(11)
        shards = [AccessOracle(m, seed=3, num_hosts=3, host_index=h)
                  for h in range(3)]
        seen = [r.block_id for o in shards for r in o.epoch_sequence(0)]
        assert sorted(seen) == sorted(b.block_id for b in m.blocks)
        assert sum(o.epoch_len() for o in shards) == 11
        with pytest.raises(ValueError):
            AccessOracle(m, seed=3, num_hosts=3, host_index=3)

    def test_window_crosses_epoch_boundary(self):
        m = make_manifest(4)
        o = AccessOracle(m, seed=1)
        win = o.window(0, 2, 5)  # 2 left in epoch 0 + 3 from epoch 1
        assert [seq for seq, _ in win] == [2, 3, 4, 5, 6]
        assert [r.block_id for _, r in win[2:]] == \
            _ids(o.epoch_sequence(1)[:3])


class TestScheduler:
    def _sched(self, n=10, length=10, **kw):
        o = AccessOracle(DatasetManifest(blocks=tuple(
            BlockRef(path="/data", block_index=i, block_id=100 + i,
                     length=length) for i in range(n))), seed=7)
        kw.setdefault("lookahead_blocks", n)
        kw.setdefault("budget_bytes", n * length)
        kw.setdefault("hbm_fraction", 0.0)
        return o, PrefetchScheduler(o, **kw)

    def test_budget_never_exceeded(self):
        o, s = self._sched(budget_bytes=35)
        rng = np.random.default_rng(0)
        held_max = 0
        for _ in range(200):
            for a in s.plan():
                s.on_loaded(a.ref.block_id)
            held = s.held_bytes(TIER_DRAM) + s.held_bytes(TIER_HBM)
            held_max = max(held_max, held)
            assert held <= 35
            epoch, pos = s.cursor()
            s.on_consume(o.epoch_sequence(epoch)[pos])
            if rng.random() < 0.3:  # jitter: replan mid-stream
                s.plan()
        assert held_max > 0

    def test_hbm_fraction_splits_the_budget(self):
        _, s = self._sched(budget_bytes=100, hbm_fraction=0.3)
        actions = s.plan()
        hbm = [a for a in actions if a.tier == TIER_HBM]
        dram = [a for a in actions if a.tier == TIER_DRAM]
        assert sum(a.ref.length for a in hbm) <= 30
        assert sum(a.ref.length for a in dram) <= 70
        assert hbm and dram

    def test_deadlines_are_consume_order(self):
        _, s = self._sched()
        actions = s.plan()
        assert [a.deadline_seq for a in actions] == \
            list(range(len(actions)))

    def test_hit_late_miss_accounting(self):
        o, s = self._sched(n=4, lookahead_blocks=2, budget_bytes=20)
        seq = o.epoch_sequence(0)
        actions = s.plan()  # plans accesses 0 and 1
        assert len(actions) == 2
        s.on_loaded(actions[0].ref.block_id)
        base = s.stats()
        assert s.on_consume(seq[0]) == "hit"
        assert s.on_consume(seq[1]) == "late"
        assert s.on_consume(seq[2]) == "miss"
        stats = s.stats()
        assert stats["hits"] - base["hits"] == 1
        assert stats["late"] - base["late"] == 1
        assert stats["misses"] - base["misses"] == 1
        s.on_loaded(actions[1].ref.block_id)
        assert s.stats()["late_arrivals"] >= base["late_arrivals"] + 1

    def test_backpressure_stops_at_nearest_deadline(self):
        _, s = self._sched(budget_bytes=25)
        actions = s.plan()
        assert [a.deadline_seq for a in actions] == [0, 1]
        assert s.plan() == []
        s.on_loaded(actions[0].ref.block_id)
        assert s.plan() == []  # ready bytes still count against budget
        s.on_consume(actions[0].ref)  # hit: frees 10 bytes
        assert len(s.plan()) == 1

    def test_failed_load_releases_budget(self):
        _, s = self._sched(budget_bytes=25, retry_backoff_s=0.0)
        actions = s.plan()
        for a in actions:
            s.on_load_failed(a.ref.block_id)
        assert s.held_bytes(TIER_DRAM) == 0
        assert len(s.plan()) == 2

    def test_failed_load_backs_off_before_replan(self):
        _, s = self._sched(budget_bytes=25, retry_backoff_s=60.0)
        failed = [a.ref.block_id for a in s.plan()]
        for bid in failed:
            s.on_load_failed(bid)
        assert s.held_bytes(TIER_DRAM) == 0
        replanned = [a.ref.block_id for a in s.plan()]
        assert replanned and not set(replanned) & set(failed)

    def test_stale_generation_consume_is_fenced(self):
        o, s = self._sched()
        gen0 = s.begin_epoch(0)
        gen1 = s.begin_epoch(0)
        seq = o.epoch_sequence(0)
        assert s.on_consume(seq[0], generation=gen0) == "stale"
        assert s.cursor() == (0, 0)
        assert s.on_consume(seq[0], generation=gen1) == "miss"
        assert s.cursor() == (0, 1)

    def test_invalidate_drops_ready_state(self):
        o, s = self._sched(budget_bytes=100)
        actions = s.plan()
        s.on_loaded(actions[0].ref.block_id)
        assert s.is_ready(actions[0].ref.block_id)
        s.on_evicted(actions[0].ref.block_id)
        assert not s.is_ready(actions[0].ref.block_id)
        assert s.held_bytes(TIER_DRAM) == \
            sum(a.ref.length for a in actions[1:])
        assert s.on_consume(o.epoch_sequence(0)[0]) != "hit"


class TestExecutorTimeout:
    def test_unpinnable_pending_block_fails_out(self):
        from alluxio_tpu_torch.prefetch.agent import WorkerTierExecutor

        class _Addr:
            pass

        class _Info:
            def __init__(self, locs):
                self.locations = locs

        class _BM:
            resident = False

            def get_block_info(self, bid):
                loc = type("L", (), {"address": _Addr()})()
                info = _Info([loc] if self.resident else [])
                info.block_id = bid
                return info

            def get_block_infos(self, bids):
                return [self.get_block_info(b) for b in bids]

            def get_worker_infos(self):
                return [type("W", (), {"address": _Addr()})()]

        class _WC:
            def async_cache(self, *a, **k):
                return True

            def prefetch_pin(self, bid):
                return False  # worker lost the block

        bm = _BM()
        ex = WorkerTierExecutor(bm, lambda addr: _WC(), load_timeout_s=0.0)
        ref = BlockRef(path="/f", block_index=0, block_id=1, length=10,
                       ufs_path="/u/f", persisted=True)
        assert ex.submit(ref)
        bm.resident = True  # committed, but the pin keeps failing
        done, failed = ex.poll()
        assert done == [] and failed == [1]
        assert not ex.pinned_blocks()


def _write_cold_corpus(cluster, fs, n_files, file_bytes, base="/prefetch"):
    from alluxio_tpu.stress.cluster import write_cold_corpus

    rng = np.random.default_rng(0)
    corpus = {f"{base}/f-{i:03d}": rng.integers(
        0, 255, size=file_bytes, dtype=np.uint8).tobytes()
        for i in range(n_files)}
    write_cold_corpus(fs, cluster.block_client(), corpus)
    return list(corpus)


def _cluster(tmp_path, **kw):
    from alluxio_tpu.conf import Keys

    return LocalCluster(
        str(tmp_path), num_workers=1, block_size=BLOCK,
        start_worker_heartbeats=True,
        conf_overrides={
            Keys.WORKER_BLOCK_HEARTBEAT_INTERVAL: "50ms",
            Keys.MASTER_WORKER_TIMEOUT: "10000min",
        }, **kw)


@pytest.fixture()
def hb_cluster(tmp_path):
    with _cluster(tmp_path) as c:
        yield c


def _make_service(fs, paths, *, hbm_fraction=0.0, seed=42, **kw):
    return PrefetchService.from_fs(fs, paths, seed=seed,
                                   lookahead_blocks=64,
                                   budget_bytes=64 << 20,
                                   hbm_fraction=hbm_fraction, **kw)


def _loader(fs, paths, **kw):
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader

    return DeviceBlockLoader(fs, paths, device="cpu", **kw)


def _tick_until_ready(svc, n, timeout_s=30.0):
    assert svc.wait_ready(n, timeout_s=timeout_s, tick=True), \
        f"never reached {n} ready placements: {svc.stats()}"


class TestEndToEnd:
    def test_two_epoch_run_hits_resident_tiers(self, hb_cluster):
        """Seeded two-epoch pass over DRAM placements (the port's
        executor driving the JAX worker): >=90% of reads served from an
        already-resident, pinned tier, in the oracle's order."""
        fs = hb_cluster.file_system()
        paths = _write_cold_corpus(hb_cluster, fs, n_files=2,
                                   file_bytes=4 * BLOCK)
        svc = _make_service(fs, paths)
        loader = _loader(fs, paths, prefetch_service=svc)
        total = len(loader)
        base = svc.stats()
        try:
            expected = {}
            for epoch in (0, 1):
                _tick_until_ready(svc, total)
                order = _ids(svc.oracle.epoch_sequence(epoch))
                out = [b.numpy().tobytes() for b in loader.epoch()]
                if epoch == 0:
                    for bid, data in zip(order, out):
                        expected[bid] = data
                else:
                    assert [expected[bid] for bid in order] == out
            stats = svc.stats()
            consumed = (stats["hits"] - base["hits"]) + \
                (stats["late"] - base["late"]) + \
                (stats["misses"] - base["misses"])
            assert consumed == 2 * total
            hit_rate = (stats["hits"] - base["hits"]) / consumed
            assert hit_rate >= 0.9, f"hit rate {hit_rate}: {stats}"
        finally:
            loader.close()
            svc.close()

    def test_hbm_placements_serve_from_device(self, hb_cluster):
        """hbm_fraction=1: the agent adopts every placement into the
        loader's device store; consumes are device-resident hits."""
        from alluxio_tpu_torch.metrics import metrics

        fs = hb_cluster.file_system()
        paths = _write_cold_corpus(hb_cluster, fs, n_files=1,
                                   file_bytes=4 * BLOCK, base="/pf-hbm")
        svc = _make_service(fs, paths, hbm_fraction=1.0)
        loader = _loader(fs, paths, hbm_bytes=16 << 20,
                         prefetch_service=svc)
        m = metrics()
        hbm_hits0 = m.counter("Client.JaxHbmHits").count
        adopted0 = m.counter("Client.PrefetchHbmAdopted").count
        base = svc.stats()
        try:
            _tick_until_ready(svc, len(loader))
            assert loader.hbm_stats()["hbm_pages"] == len(loader)
            assert m.counter("Client.PrefetchHbmAdopted").count - \
                adopted0 == len(loader)
            list(loader.epoch())
            stats = svc.stats()
            assert stats["hits"] - base["hits"] == len(loader)
            assert m.counter("Client.JaxHbmHits").count - \
                hbm_hits0 >= len(loader)
        finally:
            loader.close()
            svc.close()

    def test_metrics_surface_in_registry(self, hb_cluster):
        from alluxio_tpu_torch.metrics import metrics

        fs = hb_cluster.file_system()
        paths = _write_cold_corpus(hb_cluster, fs, n_files=1,
                                   file_bytes=2 * BLOCK, base="/pf-m")
        svc = _make_service(fs, paths)
        loader = _loader(fs, paths, prefetch_service=svc)
        try:
            _tick_until_ready(svc, len(loader))
            list(loader.epoch())
        finally:
            loader.close()
            svc.close()
        snap = metrics().snapshot()
        for name in ("Client.PrefetchHits", "Client.PrefetchLate",
                     "Client.PrefetchMisses",
                     "Client.PrefetchLoadsIssued",
                     "Client.PrefetchBlocksPinned",
                     "Client.PrefetchBlockReady.p99",
                     "Client.PrefetchInflightBytes",
                     "Client.PrefetchReadyBlocks"):
            assert name in snap, name

    def test_without_a_service_epochs_keep_file_order(self, hb_cluster):
        """Prefetching disabled is a loader with no service: the static
        file-order plan, byte for byte the JAX loader's."""
        from alluxio_tpu.client.jax_io import \
            DeviceBlockLoader as JaxDeviceBlockLoader

        fs = hb_cluster.file_system()
        data = bytes(range(256)) * (2 * BLOCK // 256)
        fs.write_all("/pf-off/data.bin", data)
        loader = _loader(fs, ["/pf-off/data.bin"])
        jl = JaxDeviceBlockLoader(fs, ["/pf-off/data.bin"])
        try:
            out = b"".join(b.numpy().tobytes() for b in loader.epoch())
            assert out == data
            assert out == b"".join(np.asarray(b).tobytes()
                                   for b in jl.epoch())
        finally:
            loader.close()
            jl.close()

    def test_job_service_executor_places_via_load_plans(self, tmp_path):
        """job_client wiring: DRAM placements ride load plans through the
        JAX job service instead of direct worker RPCs, with the same
        readiness/pinning accounting."""
        from alluxio_tpu_torch.metrics import metrics

        with _cluster(tmp_path, start_job_service=True) as cluster:
            fs = cluster.file_system()
            paths = _write_cold_corpus(cluster, fs, n_files=2,
                                       file_bytes=2 * BLOCK,
                                       base="/pf-job")
            jobs0 = metrics().counter("Client.PrefetchLoadJobs").count
            svc = _make_service(fs, paths, seed=5,
                                job_client=cluster.job_client())
            loader = _loader(fs, paths, prefetch_service=svc)
            base = svc.stats()
            try:
                _tick_until_ready(svc, len(loader))
                list(loader.epoch())
                stats = svc.stats()
                assert stats["hits"] - base["hits"] == len(loader)
                assert metrics().counter(
                    "Client.PrefetchLoadJobs").count > jobs0
            finally:
                loader.close()
                svc.close()

    def test_heartbeat_thread_drives_the_agent(self, hb_cluster):
        """The service's own heartbeat thread (no explicit ticks)
        converges the placements."""
        fs = hb_cluster.file_system()
        paths = _write_cold_corpus(hb_cluster, fs, n_files=1,
                                   file_bytes=2 * BLOCK, base="/pf-hb")
        svc = PrefetchService.from_fs(fs, paths, seed=7,
                                      heartbeat_interval_s=0.02)
        with svc:
            svc.start()
            assert svc.wait_ready(2, timeout_s=30.0)


class TestPortWorker:
    """DRAM placements on the port's own worker (in a JAX cluster with no
    worker of its own) at the default ``hbm_fraction`` of 0.25: the port's
    service and loader reach the same outcomes as the JAX service and
    loader on the same seed, over corpora of the same shape."""

    N_FILES, FILE_BLOCKS = 2, 4

    def _run(self, pkg, fs, paths):
        """Two tick-driven epochs, each after every placement is ready;
        returns per-epoch outcomes, the placement split and the bytes."""
        from alluxio_tpu.metrics import metrics as jax_metrics
        from alluxio_tpu_torch.metrics import metrics

        n = self.N_FILES * self.FILE_BLOCKS
        kw = dict(seed=11, lookahead_blocks=n, budget_bytes=n * BLOCK,
                  hbm_fraction=0.25)
        if pkg == "jax":
            from alluxio_tpu.client.jax_io import DeviceBlockLoader
            from alluxio_tpu.conf import Keys

            conf = fs.conf.copy()
            conf.set(Keys.PREFETCH_ENABLED, True)
            conf.set(Keys.PREFETCH_LOOKAHEAD_BLOCKS, n)
            conf.set(Keys.PREFETCH_BUDGET_BYTES, n * BLOCK)
            conf.set(Keys.PREFETCH_HBM_FRACTION, 0.25)
            svc = jp.PrefetchService.from_conf(conf, fs, paths, seed=11)
            loader = DeviceBlockLoader(fs, paths, hbm_bytes=4 * n * BLOCK,
                                       prefetch_service=svc)
            m = jax_metrics()
        else:
            svc = PrefetchService.from_fs(fs, paths, **kw)
            loader = _loader(fs, paths, hbm_bytes=4 * n * BLOCK,
                             prefetch_service=svc)
            m = metrics()
        loads = m.counter("Client.PrefetchLoadsIssued")
        adopts = m.counter("Client.PrefetchHbmAdopted")
        loads0, adopts0 = loads.count, adopts.count
        out = {"epochs": [], "bytes": []}
        try:
            for epoch in (0, 1):
                _tick_until_ready(svc, n)
                base = svc.stats()
                if epoch == 0:
                    out["dram_loads"] = loads.count - loads0
                    out["hbm_adopts"] = adopts.count - adopts0
                    out["pinned"] = len(svc.agent._executor.pinned_blocks())
                blocks = [np.asarray(b).tobytes() for b in loader.epoch()]
                st = svc.stats()
                out["epochs"].append({k: st[k] - base[k]
                                      for k in ("hits", "late", "misses")})
                out["bytes"].append(blocks)
        finally:
            loader.close()
            svc.close()
        return out

    def test_dram_placements_on_port_worker_match_jax(self, tmp_path):
        from alluxio_tpu.conf import Keys

        from tests.testutils.torch_worker import PortWorker

        with LocalCluster(
                str(tmp_path), num_workers=0, block_size=BLOCK,
                start_worker_heartbeats=True,
                conf_overrides={Keys.USER_SHM_ENABLED: False,
                                Keys.MASTER_WORKER_TIMEOUT: "10000min"}
        ) as cluster:
            pw = PortWorker(cluster, str(tmp_path), heartbeat_s=0.05)
            try:
                fs = cluster.file_system()
                size = self.FILE_BLOCKS * BLOCK
                runs = {}
                for pkg in ("jax", "port"):
                    paths = _write_cold_corpus(cluster, fs, self.N_FILES,
                                               size, base=f"/pf-{pkg}")
                    # _write_cold_corpus's payloads (reading the files
                    # back would cache them and spoil the cold start)
                    rng = np.random.default_rng(0)
                    want = [rng.integers(0, 255, size=size,
                                         dtype=np.uint8).tobytes()
                            for _ in paths]
                    runs[pkg] = self._run(pkg, fs, paths)
                    order = [(r.path, r.block_index) for r in AccessOracle(
                        DatasetManifest.from_fs(fs, paths),
                        seed=11).epoch_sequence(0)]
                    files = dict(zip(paths, want))
                    assert runs[pkg]["bytes"][0] == [
                        files[p][i * BLOCK:(i + 1) * BLOCK]
                        for p, i in order]
                    assert not pw.worker.store.prefetch_pinned_blocks
            finally:
                pw.stop()
        jax_run, port_run = runs["jax"], runs["port"]
        # DRAM placements landed on the port's worker, and device-tier
        # adopts, in both runs
        assert port_run["dram_loads"] > 0 and port_run["hbm_adopts"] > 0
        summary = {k: (jax_run[k], port_run[k]) for k in
                   ("epochs", "dram_loads", "hbm_adopts", "pinned")}
        for key in ("epochs", "dram_loads", "hbm_adopts", "pinned"):
            assert port_run[key] == jax_run[key], summary
        assert [len(e) for e in port_run["bytes"]] == \
            [len(e) for e in jax_run["bytes"]]


# -- PrefetchService.from_conf ------------------------------------------------
FROM_CONF_CASES = (
    {},
    {"atpu.prefetch.enabled": "true"},
    {"atpu.prefetch.enabled": "true", "atpu.prefetch.lookahead.blocks": "5",
     "atpu.prefetch.budget.bytes": "3MB", "atpu.prefetch.hbm.fraction": "0.5",
     "atpu.prefetch.heartbeat.interval.ms": "25ms"},
    {"prefetch.enabled": "true", "prefetch.lookahead.blocks": "2",
     "prefetch.budget.bytes": "1000", "prefetch.hbm.fraction": "1.0",
     "prefetch.heartbeat.interval.ms": "2s"},
    {"atpu.prefetch.enabled": "false", "atpu.prefetch.lookahead.blocks": "5"},
)


def _knobs(svc):
    if svc is None:
        return None
    s = svc.scheduler
    return (s._lookahead, s._budget, s._hbm_budget, s._hbm_fraction,
            svc._interval, type(svc.agent._executor).__name__)


@pytest.mark.parametrize("props", FROM_CONF_CASES,
                         ids=lambda p: ",".join(f"{k.split('.')[-1]}={v}"
                                                for k, v in p.items())
                         or "defaults")
@pytest.mark.parametrize("with_jobs", (False, True), ids=("worker", "jobs"))
def test_from_conf_builds_what_jax_builds(hb_cluster, props, with_jobs):
    """For the same properties (canonical names and their aliases), both
    packages' ``from_conf`` build a loop with equal lookahead, budget,
    HBM fraction and heartbeat interval and the same kind of executor, or
    both return None when the service is off."""
    from alluxio_tpu.conf import Configuration as JaxConfiguration
    from alluxio_tpu_torch.conf import Configuration

    fs = hb_cluster.file_system()
    paths = _write_cold_corpus(hb_cluster, fs, n_files=1,
                               file_bytes=2 * BLOCK, base="/pf-conf")
    jobs = object() if with_jobs else None
    got = []
    for pkg_conf, svc_cls in ((JaxConfiguration, jp.PrefetchService),
                              (Configuration, PrefetchService)):
        svc = svc_cls.from_conf(pkg_conf(dict(props), load_env=False), fs,
                                paths, seed=3, job_client=jobs)
        got.append(_knobs(svc))
        if svc is not None:
            svc.close()
    assert got[0] == got[1]
    enabled = props.get("atpu.prefetch.enabled",
                        props.get("prefetch.enabled")) == "true"
    assert (got[1] is None) == (not enabled)
