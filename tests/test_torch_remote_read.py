"""The port's striped remote read against the JAX package's, on the CPU.

- ``plan_stripes``, ``choose_route`` and ``LatencyStats`` over a seeded
  sweep: the JAX results.
- The striped reassembly sweep of ``tests/test_remote_read.py`` through
  both packages' runtimes on the same fake sources: the source bytes, in
  both consumption modes.
- The hedge, re-route, truncation and window cases of
  ``tests/test_remote_read.py``, on the port.
- Over real gRPC against the port's worker (the one worker of a JAX
  ``LocalCluster``): the port's ``GrpcBlockInStream`` single-stream,
  striped over pooled channels, and batched (``read_many``) gives the
  bytes the JAX stream gives.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu.client import remote_read as jax_rr  # noqa: E402
from alluxio_tpu.client.block_streams import \
    BatchReadConf as JaxBatchReadConf  # noqa: E402
from alluxio_tpu.utils.exceptions import \
    UnavailableError as JaxUnavailableError  # noqa: E402
from alluxio_tpu_torch.client import remote_read as rr  # noqa: E402
from alluxio_tpu_torch.client.block_streams import BatchReadConf  # noqa: E402
from alluxio_tpu_torch.utils.exceptions import UnavailableError  # noqa: E402
from tests.test_remote_read import FakeSource  # noqa: E402

KB = 1024


def _runtime(mod, **kw):
    kw.setdefault("stripe_size", 10 * KB)
    kw.setdefault("concurrency", 4)
    kw.setdefault("window_bytes", 0)
    kw.setdefault("hedge_quantile", 0.0)
    return mod.RemoteReadRuntime(mod.RemoteReadConf(**kw))


def _counter(name):
    from alluxio_tpu_torch.metrics import metrics

    return metrics().counter(name).count


# -- planning ------------------------------------------------------------------
def test_plan_stripes_and_choose_route_match_jax():
    rng = np.random.default_rng(31)
    for _ in range(300):
        length = int(rng.integers(-5, 50 * KB))
        stripe = int(rng.choice([0, 1, 7, 4 * KB, 16 * KB, 1 << 20]))
        assert rr.plan_stripes(length, stripe) == \
            jax_rr.plan_stripes(length, stripe)
        shm = bool(rng.random() < 0.2)
        ops = int(rng.integers(0, 4))
        batch = [None, (True, 64 * KB, 256), (False, 64 * KB, 256),
                 (True, 1 * KB, 8)][int(rng.integers(4))]
        striped = [None, dict(stripe_size=stripe),
                   dict(stripe_size=0)][int(rng.integers(3))]
        got = rr.choose_route(
            length, same_host_shm=shm, batch_ops=ops,
            batch=None if batch is None else BatchReadConf(*batch),
            striped=None if striped is None else rr.RemoteReadConf(**striped))
        want = jax_rr.choose_route(
            length, same_host_shm=shm, batch_ops=ops,
            batch=None if batch is None else JaxBatchReadConf(*batch),
            striped=None if striped is None
            else jax_rr.RemoteReadConf(**striped))
        assert got == want


def test_latency_stats_match_jax():
    rng = np.random.default_rng(32)
    port, jax = rr.LatencyStats(), jax_rr.LatencyStats()
    for _ in range(200):
        key = f"w{int(rng.integers(3))}"
        lat = float(rng.exponential(0.01))
        port.observe(key, lat)
        jax.observe(key, lat)
        for q in (0.0, 0.5, 0.9, 0.95, 0.999):
            assert port.hedge_delay_s(key, q) == jax.hedge_delay_s(key, q)
    assert port.snapshot() == jax.snapshot()


def test_conf_from_keys():
    from alluxio_tpu_torch.conf import Configuration, Keys

    conf = Configuration(load_env=False)
    assert rr.RemoteReadConf.from_conf(conf) == rr.RemoteReadConf()
    conf.set(Keys.USER_REMOTE_READ_STRIPE_SIZE, "1MB")
    assert rr.RemoteReadConf.from_conf(conf).stripe_size == 1 << 20
    assert BatchReadConf.from_conf(conf) == BatchReadConf()


# -- reassembly ----------------------------------------------------------------
@pytest.mark.parametrize("length,stripe,window,chunk,offset", [
    (1, 1, 0, 1, 0),
    (100, 7, 0, 3, 0),
    (1023, 100, 150, 64, 13),
    (4096, 1000, 1000, 333, 1),
    (10_000, 999, 2500, 1 << 20, 7),
    (65_537, 8 * KB, 12 * KB, 5000, 0),
    (33_333, 10 * KB, 1, 4 * KB, 111),   # window < stripe must not hang
    (300 * KB, 64 * KB, 128 * KB, 70 * KB, 5),  # native stripe commits
])
def test_reassembly_matches_jax(length, stripe, window, chunk, offset):
    data = bytes(i * 31 % 251 for i in range(offset + length))
    want = data[offset:offset + length]
    for mod in (rr, jax_rr):
        rt = _runtime(mod, stripe_size=stripe, window_bytes=window,
                      concurrency=3)
        srcs = [FakeSource("a", data), FakeSource("b", data)]
        try:
            view = rt.read(block_id=1, sources=srcs, offset=offset,
                           length=length, chunk_size=chunk).read_view()
            assert bytes(view) == want, mod.__name__
            out = bytearray()
            read = rt.read(block_id=2, sources=srcs, offset=offset,
                           length=length, chunk_size=chunk)
            for v in read.iter_views(chunk_size=chunk):
                out.extend(v)
            assert bytes(out) == want, mod.__name__
        finally:
            rt.close()


def test_zero_length_read():
    rt = _runtime(rr)
    try:
        read = rt.read(block_id=1, sources=[FakeSource("a", b"")],
                       offset=0, length=0)
        assert bytes(read.read_view()) == b""
        assert list(read.iter_views()) == []
    finally:
        rt.close()


# -- hedges, re-routes, truncation, window ------------------------------------
def test_midstream_death_reroutes_and_reports(n_stripes=8):
    data = bytes(i % 256 for i in range(n_stripes * 10 * KB))
    failed = []
    dead = FakeSource("w-dead", data, die_after=4 * KB)
    ok = FakeSource("w-ok", data)
    rt = _runtime(rr)
    try:
        read = rt.read(block_id=1, sources=[dead, ok], offset=0,
                       length=len(data), chunk_size=2 * KB,
                       on_failed=failed.append)
        assert bytes(read.read_view()) == data
    finally:
        rt.close()
    assert "w-dead" in failed
    assert read.reroutes > 0
    assert ok.opens >= n_stripes - dead.opens


def test_truncated_source_serves_available_bytes():
    full = bytes(i % 256 for i in range(50 * KB))
    served = 23 * KB
    failed = []
    rt = _runtime(rr, stripe_size=10 * KB)
    try:
        read = rt.read(block_id=1, sources=[FakeSource("a", full[:served])],
                       offset=0, length=len(full), chunk_size=4 * KB,
                       on_failed=failed.append)
        assert bytes(read.read_view()) == full[:served]
    finally:
        rt.close()
    assert failed == []


def test_all_replicas_dead_raises():
    data = bytes(50 * KB)
    rt = _runtime(rr)
    try:
        read = rt.read(
            block_id=1, sources=[FakeSource("a", data, die_after=0),
                                 FakeSource("b", data, die_after=0)],
            offset=0, length=len(data))
        # the last source's own error (the fakes raise the JAX class)
        with pytest.raises(JaxUnavailableError, match="died"):
            read.read_view()
    finally:
        rt.close()


def test_hedged_request_first_answer_wins():
    data = bytes(i % 256 for i in range(80 * KB))
    rt = _runtime(rr, hedge_quantile=0.9, concurrency=2)
    slow = FakeSource("w-slow", data)
    fast = FakeSource("w-fast", data)
    for k in ("w-slow", "w-fast"):
        for _ in range(8):
            rt.stats.observe(k, 0.002)
    slow.delay = 0.25  # now it straggles far past its own q-quantile
    h0, w0 = _counter("Client.RemoteReadHedges"), \
        _counter("Client.RemoteReadHedgeWins")
    try:
        read = rt.read(block_id=1, sources=[slow, fast], offset=0,
                       length=len(data), chunk_size=16 * KB)
        assert bytes(read.read_view()) == data
    finally:
        rt.close()
    assert read.hedges > 0 and read.hedge_wins > 0
    assert _counter("Client.RemoteReadHedges") - h0 == read.hedges
    assert _counter("Client.RemoteReadHedgeWins") - w0 == read.hedge_wins


def test_window_caps_inflight_stripes():
    stripe = 10 * KB
    data = bytes(10 * stripe)
    gate = threading.Event()
    src = FakeSource("a", data, gate=gate)
    rt = _runtime(rr, stripe_size=stripe, window_bytes=2 * stripe,
                  concurrency=8)
    try:
        read = rt.read(block_id=1, sources=[src], offset=0,
                       length=len(data))
        t = threading.Thread(target=read.read_view)
        t.start()
        deadline = time.monotonic() + 5
        while src.live < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)  # would-be over-submissions get a chance to open
        assert src.max_live == 2  # frontier stripe + one of readahead
        gate.set()
        t.join(timeout=20)
        assert not t.is_alive()
    finally:
        gate.set()
        rt.close()


def test_closed_runtime_fails_reads():
    rt = _runtime(rr)
    rt.close()
    read = rt.read(block_id=1, sources=[FakeSource("a", bytes(30 * KB))],
                   offset=0, length=30 * KB)
    with pytest.raises(UnavailableError):
        read.read_view()


# -- real gRPC against the port's worker ---------------------------------------
BLOCK = 256 * KB


@pytest.fixture(scope="module")
def port_worker(tmp_path_factory):
    from alluxio_tpu.minicluster import LocalCluster

    from tests.testutils.torch_worker import PortWorker

    base = tmp_path_factory.mktemp("rr")
    with LocalCluster(str(base), num_workers=0, block_size=BLOCK) as cluster:
        pw = PortWorker(cluster, str(base))
        try:
            fs = cluster.file_system()
            data = np.random.default_rng(33).integers(
                0, 256, BLOCK, dtype=np.uint8).tobytes()
            fs.write_all("/rr", data, write_type="MUST_CACHE")
            bid = fs.get_status("/rr").block_ids[0]
            fs.close()
            yield f"localhost:{pw.port}", bid, data
        finally:
            pw.stop()


def _stream(side, address, bid, stripe, batch=True):
    """One package's GrpcBlockInStream over its own WorkerClient."""
    import importlib

    from alluxio_tpu_torch.utils.wire import WorkerNetAddress

    prefix = "alluxio_tpu_torch" if side == "port" else "alluxio_tpu"
    wc = importlib.import_module(f"{prefix}.rpc.clients").WorkerClient
    bs = importlib.import_module(f"{prefix}.client.block_streams")
    mod = rr if side == "port" else jax_rr
    rt = mod.RemoteReadRuntime(mod.RemoteReadConf(
        stripe_size=stripe, window_bytes=96 * KB, hedge_quantile=0.0))
    stream = bs.GrpcBlockInStream(
        wc(address), bid, BLOCK, chunk_size=16 * KB, remote_read=rt,
        batch=bs.BatchReadConf() if batch else None)
    host, port = address.split(":")
    if side == "port":
        stream.address = WorkerNetAddress(host=host, rpc_port=int(port))
    else:
        from alluxio_tpu.utils.wire import WorkerNetAddress as JaxAddress

        stream.address = JaxAddress(host=host, rpc_port=int(port))
    return stream, rt


@pytest.mark.parametrize("stripe", [0, 64 * KB, 48 * KB + 1])
def test_grpc_reads_match_jax(port_worker, stripe):
    address, bid, data = port_worker
    rng = np.random.default_rng(34)
    offsets = [int(o) for o in rng.integers(0, BLOCK, 40)]
    sizes = [int(s) for s in rng.choice([0, 1, 7, 512, 4096, 64 * KB], 40)]
    results = {}
    for side in ("jax", "port"):
        s0 = _counter("Client.RemoteReadStripes")
        stream, rt = _stream(side, address, bid, stripe)
        try:
            results[side] = (
                bytes(stream.read_all_view()),
                stream.pread(1000, 200 * KB),
                stream.pread_many(offsets, sizes),
                stream.last_source)
        finally:
            rt.close()
        if side == "port":
            assert (_counter("Client.RemoteReadStripes") > s0) == \
                (stripe > 0)
    assert results["port"] == results["jax"]
    whole, part, many, source = results["port"]
    assert whole == data and part == data[1000:1000 + 200 * KB]
    assert many == [data[o:o + s] for o, s in zip(offsets, sizes)]
    assert source == "MEM"


def test_batched_reads_coalesce(port_worker):
    address, bid, data = port_worker
    offsets, sizes = list(range(0, 300 * 64, 64)), [32] * 300
    b0, f0 = _counter("Client.BatchReadBatches"), \
        _counter("Client.BatchReadFallbacks")
    stream, rt = _stream("port", address, bid, 0)
    try:
        got = stream.pread_many(offsets, sizes)
        per_op, rt2 = _stream("port", address, bid, 0, batch=False)
        assert per_op.pread_many(offsets, sizes) == got
        rt2.close()
    finally:
        rt.close()
    assert got == [data[o:o + 32] for o in offsets]
    # 300 ops at the default 256 a batch: two read_many RPCs
    assert _counter("Client.BatchReadBatches") - b0 == 2
    assert _counter("Client.BatchReadFallbacks") == f0
