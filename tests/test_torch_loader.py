"""The port's DeviceBlockLoader on the CPU, over the JAX package's
LocalCluster FileSystem: the nine cases of ``tests/test_device_loader.py``
plus byte parity with the JAX loader (bytes compared exactly)."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu.minicluster import LocalCluster  # noqa: E402

BLOCK = 64 * 1024


@pytest.fixture()
def cluster(tmp_path):
    with LocalCluster(str(tmp_path), num_workers=1,
                      block_size=BLOCK) as c:
        yield c


def _make_loader(cluster, n_blocks=4, hbm_bytes=0, prefetch=2):
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader

    fs = cluster.file_system()
    data = bytes(range(256)) * (n_blocks * BLOCK // 256)
    fs.write_all("/loader/data.bin", data)
    loader = DeviceBlockLoader(fs, ["/loader/data.bin"], device="cpu",
                               hbm_bytes=hbm_bytes, prefetch=prefetch)
    return loader, data


def _bytes(t):
    return t.numpy().tobytes()


def _hbm_hits():
    from alluxio_tpu_torch.metrics import metrics

    return metrics().counter("Client.JaxHbmHits").count


class TestEpoch:
    def test_epoch_yields_all_blocks_in_order(self, cluster):
        loader, data = _make_loader(cluster)
        try:
            out = b"".join(_bytes(b) for b in loader.epoch())
            assert out == data
        finally:
            loader.close()

    def test_hbm_retention_serves_second_epoch(self, cluster):
        loader, data = _make_loader(cluster, hbm_bytes=16 << 20)
        try:
            list(loader.epoch())
            hits0 = _hbm_hits()
            out = b"".join(_bytes(b) for b in loader.epoch())
            assert out == data
            assert _hbm_hits() - hits0 >= len(loader)
        finally:
            loader.close()

    def test_load_block_single(self, cluster):
        loader, data = _make_loader(cluster)
        try:
            arr = loader.load_block(1)
            assert arr.device.type == "cpu"
            assert _bytes(arr) == data[BLOCK:2 * BLOCK]
        finally:
            loader.close()


class TestLifecycle:
    def test_close_with_live_partial_generator(self, cluster):
        loader, _ = _make_loader(cluster, n_blocks=6, prefetch=1)
        it = loader.epoch()
        next(it)  # producer is now parked on the full bounded queue
        loader.close()  # must return, not hang on pool shutdown

    def test_use_after_close_raises(self, cluster):
        loader, _ = _make_loader(cluster)
        stale = loader.epoch()  # generator body not started yet
        loader.close()
        with pytest.raises(RuntimeError, match="closed"):
            next(stale)
        with pytest.raises(RuntimeError, match="closed"):
            loader.load_block(0)
        assert loader._producer_pool is None  # nothing resurrected

    def test_new_epoch_cancels_stale_generator(self, cluster):
        loader, data = _make_loader(cluster, n_blocks=6, prefetch=1)
        try:
            stale = loader.epoch()
            next(stale)  # keep a reference; never exhaust it
            out = b"".join(_bytes(b) for b in loader.epoch())
            assert out == data
            # the superseded iterator fails loudly, never truncates
            with pytest.raises(RuntimeError, match="cancelled"):
                list(stale)
        finally:
            loader.close()

    def test_break_mid_epoch_retires_producer(self, cluster):
        loader, data = _make_loader(cluster, n_blocks=6, prefetch=1)
        try:
            for b in loader.epoch():
                break  # generator closed here; teardown is synchronous
            assert loader._producer_pool is None
            assert not [t for t in threading.enumerate()
                        if t.name.startswith("loader-host-prefetch")]
            assert loader._all_streams == []
            out = b"".join(_bytes(b) for b in loader.epoch())
            assert out == data
        finally:
            loader.close()
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("loader-host-prefetch")]

    def test_generator_close_mid_epoch_retires_producer(self, cluster):
        loader, _ = _make_loader(cluster, n_blocks=6, prefetch=1)
        try:
            it = loader.epoch()
            next(it)
            it.close()
            assert loader._producer_pool is None
            assert not [t for t in threading.enumerate()
                        if t.name.startswith("loader-host-prefetch")]
        finally:
            loader.close()

    def test_read_failure_fails_epoch(self, cluster):
        loader, _ = _make_loader(cluster)
        loader._plan.append(("/loader/does-not-exist", 0, None))
        try:
            with pytest.raises(Exception):
                list(loader.epoch())
        finally:
            loader.close()


class TestObservability:
    def test_phases_and_metric_names(self, cluster):
        from alluxio_tpu_torch.metrics import metrics
        from alluxio_tpu_torch.utils.tracing import (set_tracing_enabled,
                                                     tracer)

        loader, _ = _make_loader(cluster)
        m = metrics()
        names = ("Client.JaxShortCircuitBlocks", "Client.JaxStreamedBlocks")
        before = sum(m.counter(n).count for n in names)
        set_tracing_enabled(True)
        try:
            with tracer().span("step") as span:
                blocks = list(loader.epoch())
        finally:
            set_tracing_enabled(False)
            loader.close()
        assert len(blocks) == 4
        assert sum(m.counter(n).count for n in names) - before == 4
        assert [name for name, _ms in span.phases] == ["drain"] * 4
        # host->device time under the JAX loader's phase name, on the
        # h2d spans nested in the step
        h2d = [s for s in tracer().snapshot()
               if s["name"] == "atpu.loader.h2d"
               and s["parent"] == span.span_id]
        assert len(h2d) == 4
        assert all([p[0] for p in s["phases"]] == ["device_put"]
                   for s in h2d)
        snap = m.snapshot()
        assert any(k.startswith("Client.InputStallCount.") for k in snap)
        assert "Client.InputBoundFraction" in snap
        assert loader.stall_report()["ranked"]


class TestParity:
    @pytest.mark.parametrize("dtype", [np.uint8, np.int32])
    def test_epoch_bytes_match_jax_loader(self, cluster, dtype):
        from alluxio_tpu.client.jax_io import \
            DeviceBlockLoader as JaxDeviceBlockLoader
        from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader

        fs = cluster.file_system()
        rng = np.random.default_rng(9)
        data = rng.integers(0, 256, size=3 * BLOCK + 4096,
                            dtype=np.uint8).tobytes()
        fs.write_all("/parity/a.bin", data)
        fs.write_all("/parity/b.bin", data[::-1])
        paths = ["/parity/a.bin", "/parity/b.bin"]
        jl = JaxDeviceBlockLoader(fs, paths, hbm_bytes=1 << 20, dtype=dtype)
        tl = DeviceBlockLoader(fs, paths, device="cpu", hbm_bytes=1 << 20,
                               dtype=dtype)
        try:
            assert tl.plan == jl.plan
            for _ in range(2):  # host epoch, then device-tier epoch
                want = [np.asarray(b) for b in jl.epoch()]
                got = [b.numpy() for b in tl.epoch()]
                assert [g.dtype for g in got] == [w.dtype for w in want]
                assert [g.tobytes() for g in got] == \
                    [w.tobytes() for w in want]
            assert tl.hbm_stats() == jl.hbm_stats()
        finally:
            jl.close()
            tl.close()


class TestPrefetchService:
    def test_hbm_placements_serve_from_device(self, tmp_path):
        """The JAX package's clairvoyant prefetch service drives the
        port's loader through the duck-typed hooks: the agent adopts
        every placement into the port's device store (through
        ``prefetch_into_hbm``), and the epoch consumes the oracle's
        seeded order as device-tier hits."""
        from alluxio_tpu.conf import Keys
        from alluxio_tpu.prefetch import PrefetchService
        from alluxio_tpu.stress.cluster import write_cold_corpus
        from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader

        with LocalCluster(
                str(tmp_path), num_workers=1, block_size=BLOCK,
                start_worker_heartbeats=True,
                conf_overrides={
                    Keys.WORKER_BLOCK_HEARTBEAT_INTERVAL: "50ms",
                    Keys.MASTER_WORKER_TIMEOUT: "10000min",
                }) as c:
            fs = c.file_system()
            rng = np.random.default_rng(0)
            corpus = {"/pf-hbm/f-000": rng.integers(
                0, 255, size=4 * BLOCK, dtype=np.uint8).tobytes()}
            write_cold_corpus(fs, c.block_client(), corpus)
            paths = list(corpus)
            conf = c.conf.copy()
            conf.set(Keys.PREFETCH_ENABLED, True)
            conf.set(Keys.PREFETCH_LOOKAHEAD_BLOCKS, 64)
            conf.set(Keys.PREFETCH_BUDGET_BYTES, 64 << 20)
            conf.set(Keys.PREFETCH_HBM_FRACTION, 1.0)
            svc = PrefetchService.from_conf(conf, fs, paths, seed=42)
            loader = DeviceBlockLoader(fs, paths, device="cpu",
                                       hbm_bytes=16 << 20,
                                       prefetch_service=svc)
            hits0 = _hbm_hits()
            base = svc.stats()
            try:
                assert svc.wait_ready(len(loader), timeout_s=30.0,
                                      tick=True), svc.stats()
                assert loader.hbm_stats()["hbm_pages"] == len(loader)
                order = [r.block_index
                         for r in svc.oracle.epoch_sequence(0)]
                out = [_bytes(b) for b in loader.epoch()]
                data = corpus[paths[0]]
                assert out == [data[i * BLOCK:(i + 1) * BLOCK]
                               for i in order]
                assert svc.stats()["hits"] - base["hits"] == len(loader)
                assert _hbm_hits() - hits0 >= len(loader)
            finally:
                loader.close()
                svc.close()

    def test_port_service_on_scheduled_timers(self, tmp_path):
        """The port's own service, its heartbeat thread forced onto a
        scheduled timer and ticked by hand: each tick plans the window
        and the adopt thread fills the port loader's device store, and
        the epoch is the oracle's order as device-tier hits, the same
        order the JAX oracle gives for the seed."""
        from alluxio_tpu.prefetch import AccessOracle as JaxAccessOracle
        from alluxio_tpu.prefetch import DatasetManifest as JaxManifest
        from alluxio_tpu.stress.cluster import write_cold_corpus
        from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
        from alluxio_tpu_torch.heartbeat import (HeartbeatContext,
                                                 HeartbeatScheduler,
                                                 HeartbeatThread)
        from alluxio_tpu_torch.prefetch import PrefetchService

        from alluxio_tpu.conf import Keys

        name = HeartbeatContext.CLIENT_PREFETCH_AGENT
        with LocalCluster(
                str(tmp_path), num_workers=1, block_size=BLOCK,
                start_worker_heartbeats=True,
                conf_overrides={
                    Keys.WORKER_BLOCK_HEARTBEAT_INTERVAL: "50ms",
                    Keys.MASTER_WORKER_TIMEOUT: "10000min",
                }) as c:
            fs = c.file_system()
            rng = np.random.default_rng(1)
            corpus = {f"/pf-sched/f-{i}": rng.integers(
                0, 255, size=3 * BLOCK, dtype=np.uint8).tobytes()
                for i in range(2)}
            write_cold_corpus(fs, c.block_client(), corpus)
            paths = list(corpus)
            svc = PrefetchService.from_fs(fs, paths, seed=42,
                                          lookahead_blocks=4,
                                          budget_bytes=4 * BLOCK,
                                          hbm_fraction=1.0)
            loader = DeviceBlockLoader(fs, paths, device="cpu",
                                       hbm_bytes=16 << 20,
                                       prefetch_service=svc)
            HeartbeatThread.use_scheduled_timers(name)
            try:
                svc.start()
                HeartbeatScheduler.execute(name)
                assert svc.wait_ready(4, timeout_s=30.0), svc.stats()
                assert loader.hbm_stats()["hbm_pages"] == 4
                HeartbeatScheduler.execute(name)  # budget full: no plans
                assert svc.stats()["inflight_blocks"] == 0
                order = svc.oracle.epoch_sequence(0)
                want = JaxAccessOracle(JaxManifest.from_fs(fs, paths),
                                       seed=42).epoch_sequence(0)
                assert [r.block_id for r in order] == \
                    [r.block_id for r in want]
                hits0 = _hbm_hits()
                out = [_bytes(b) for b in loader.epoch()]
                assert out == [corpus[r.path][
                    r.block_index * BLOCK:(r.block_index + 1) * BLOCK]
                    for r in order]
                assert _hbm_hits() - hits0 >= 4
                assert svc.stats()["hits"] >= 4
            finally:
                HeartbeatThread.reset_timer_policy()
                loader.close()
                svc.close()
                HeartbeatScheduler.clear()
