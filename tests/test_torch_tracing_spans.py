"""The spans and the counter inside the port's read path, on the CPU over
the port's own ``LocalCluster``: the producer's host read split into the
view and the pre-fault, the host-to-device copy's staging steps, the
loader's queue from both sides, the device tier's evictions and decode's
range; and the clock the ring's spans share with a ``torch.profiler``
trace. One card test profiles the staging allocation and decode's CUDA
API calls (marker ``cuda``; on the card:
``python -m pytest -m cuda tests/test_torch_tracing_spans.py``)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

BLOCK = 64 * 1024
N_BLOCKS = 4


@pytest.fixture()
def cluster(tmp_path):
    from alluxio_tpu_torch.minicluster import LocalCluster

    with LocalCluster(str(tmp_path / "cluster"), num_workers=1,
                      block_size=BLOCK) as c:
        yield c


@pytest.fixture()
def traced():
    """The port's tracer on, with an empty ring; off again after."""
    from alluxio_tpu_torch.utils import tracing

    tracing.tracer().clear()
    tracing.set_tracing_enabled(True)
    try:
        yield tracing.tracer()
    finally:
        tracing.set_tracing_enabled(False)
        tracing.tracer().clear()


def _loader(cluster, hbm_bytes=0):
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader

    fs = cluster.file_system()
    rng = np.random.default_rng(26)
    data = rng.integers(0, 256, size=N_BLOCKS * BLOCK,
                        dtype=np.uint8).tobytes()
    fs.write_all("/spans/data.bin", data)
    return DeviceBlockLoader(fs, ["/spans/data.bin"], device="cpu",
                             hbm_bytes=hbm_bytes, prefetch=1), data


def _spans(tr, name):
    return [s for s in tr.snapshot(limit=10_000) if s["name"] == name]


def _children(tr, parent, name):
    return [s for s in _spans(tr, name) if s["parent"] == parent["span_id"]]


def _epoch_under_tracer(cluster, traced, hbm_bytes=0):
    # the loader's FileSystem resets tracing from its conf: open it first
    loader, data = _loader(cluster, hbm_bytes)
    traced.enabled = True
    try:
        got = b"".join(b.numpy().tobytes() for b in loader.epoch())
    finally:
        loader.close()
    assert got == data


def test_host_read_splits_into_view_and_prefault(cluster, traced):
    _epoch_under_tracer(cluster, traced)
    reads = _spans(traced, "atpu.loader.host_read")
    assert len(reads) == N_BLOCKS
    for r in reads:
        (view,) = _children(traced, r, "atpu.loader.view")
        (fault,) = _children(traced, r, "atpu.loader.prefault")
        assert view["start_ms"] <= fault["start_ms"]
        assert view["duration_ms"] + fault["duration_ms"] <= \
            r["duration_ms"] + 1e-3
        # the SHM transport's phases land on the live span: the view
        assert "phases" not in r
        assert {p[0] for p in view.get("phases", [])} <= \
            {"lease_wait", "shm_map"}
    assert any(p[0] == "shm_map" for r in reads
               for v in _children(traced, r, "atpu.loader.view")
               for p in v.get("phases", []))


def test_h2d_holds_the_staging_copy(cluster, traced):
    _epoch_under_tracer(cluster, traced)
    h2d = _spans(traced, "atpu.loader.h2d")
    assert len(h2d) == N_BLOCKS
    for s in h2d:
        (copy,) = _children(traced, s, "atpu.h2d.stage_copy")
        assert copy["duration_ms"] <= s["duration_ms"] + 1e-3
        # the CPU's private copy needs no pinned staging
        assert _children(traced, s, "atpu.h2d.stage_alloc") == []
        assert [p[0] for p in s.get("phases", [])] == ["device_put"]


@pytest.mark.parametrize("hbm_bytes", [0, 16 << 20])
def test_one_queue_span_a_side_for_each_item(cluster, traced, hbm_bytes):
    """The consumer waits once, and the producer hands over once, for each
    block and for the end-of-epoch marker; a second epoch served from the
    device tier does the same."""
    loader, data = _loader(cluster, hbm_bytes)
    traced.enabled = True
    epochs = 2 if hbm_bytes else 1
    try:
        for _ in range(epochs):
            blocks = list(loader.epoch())
            assert b"".join(b.numpy().tobytes() for b in blocks) == data
        taken = sum(loader.step_stats.count.values())
    finally:
        loader.close()
    assert taken == epochs * N_BLOCKS
    waits = _spans(traced, "atpu.loader.queue_wait")
    puts = _spans(traced, "atpu.loader.queue_put")
    assert len(waits) == len(puts) == epochs * (N_BLOCKS + 1)
    assert {s["thread"] for s in puts}.isdisjoint(
        {s["thread"] for s in waits})
    assert all(s["thread"].startswith("loader-host-prefetch") for s in puts)


def test_evictions_count_only_what_the_policy_evicts():
    from alluxio_tpu_torch.client.cache.hbm_store import HbmPageStore
    from alluxio_tpu_torch.client.cache.meta import PageId
    from alluxio_tpu_torch.metrics import metrics

    counter = metrics().counter("Client.HbmEvictions")
    store = HbmPageStore(3 * 1024, device="cpu")
    page = bytes(1024)
    n0 = counter.count
    for i in range(3):
        assert store.put(PageId("f", i), page)
    assert counter.count == n0
    for i in range(3, 6):  # each put past capacity evicts one page
        assert store.put(PageId("f", i), page)
    assert counter.count == n0 + 3
    lease = store.get(PageId("f", 3))  # pinned: skipped by the policy
    assert store.put(PageId("f", 6), page)
    assert counter.count == n0 + 4
    assert store.has(PageId("f", 3))
    lease.close()
    # refused adopts, an explicit delete and close() evict nothing
    assert not store.put(PageId("big", 0), bytes(4 * 1024))
    assert store.delete(PageId("f", 6))
    store.close()
    assert store.page_count == 0
    assert counter.count == n0 + 4


def test_loader_counts_a_tier_eviction_for_each_block_past_its_room(
        cluster):
    from alluxio_tpu_torch.metrics import metrics

    counter = metrics().counter("Client.HbmEvictions")
    n0 = counter.count
    loader, data = _loader(cluster, hbm_bytes=2 * BLOCK + BLOCK // 2)
    try:
        got = b"".join(b.numpy().tobytes() for b in loader.epoch())
    finally:
        loader.close()
    assert got == data
    # a cyclic scan through a two-page tier: every block past the second
    # evicts one; the loader's close() evicts nothing
    assert counter.count - n0 == N_BLOCKS - 2


def _records(n=5, h=4, w=6, c=3, seed=7):
    from alluxio_tpu_torch.ops.decode import encode_image_records

    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, size=(n, h, w, c), dtype=np.uint8)
    labels = rng.integers(-2**31, 2**31 - 1, size=n, dtype=np.int32)
    raw = np.frombuffer(encode_image_records(imgs, labels), dtype=np.uint8)
    return torch.from_numpy(raw.reshape(n, -1).copy()), imgs, labels


def test_decode_runs_under_its_span_and_its_outputs_stay(traced):
    from alluxio_tpu_torch.ops.decode import (IMAGENET_MEAN, IMAGENET_STD,
                                              decode_image_records)

    recs, imgs, labels = _records()
    with traced.span("step") as step:
        got_imgs, got_labels = decode_image_records(recs, height=4, width=6,
                                                    channels=3)
    (span,) = _spans(traced, "atpu.decode.images")
    assert span["parent"] == step.span_id
    # the op order of the JAX package, in float32, then bf16
    want = (imgs.astype(np.float32) / np.float32(255.0)
            - np.asarray(IMAGENET_MEAN, np.float32)) \
        / np.asarray(IMAGENET_STD, np.float32)
    want = torch.from_numpy(want).to(torch.bfloat16)
    assert got_imgs.dtype == torch.bfloat16
    assert torch.equal(got_imgs.view(torch.int16), want.view(torch.int16))
    assert got_labels.dtype == torch.int32
    assert np.array_equal(got_labels.numpy(), labels)


def test_ring_spans_and_profiler_ranges_share_the_unix_clock(tmp_path,
                                                             traced):
    """A span's ``start_ms`` in the ring and its range's start in the
    exported Chrome trace (``ts`` plus ``baseTimeNanoseconds``) agree
    within 1 ms: ``fsadmin trace`` spans lie over a device trace."""
    from alluxio_tpu_torch.utils.tracing import annotate

    with annotate("atpu.test.clock_warm"):
        pass
    names = [f"atpu.test.clock{i}" for i in range(5)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("atpu.test.clock_warm"):
            pass
        for name in names:
            with annotate(name):
                sum(range(1000))
    path = tmp_path / "clock.trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    ring = {s["name"]: s for s in traced.snapshot(limit=100)}
    gaps = []
    for name in names:
        (ev,) = [e for e in trace["traceEvents"] if e.get("name") == name
                 and e.get("ph") == "X"]
        gaps.append(abs((ev["ts"] + base_us) / 1e3 - ring[name]["start_ms"]))
    assert sorted(gaps)[len(gaps) // 2] < 1.0, gaps


@pytest.mark.cuda
def test_card_staging_alloc_and_decode_api_calls(tmp_path):
    """On the card: the pinned allocation is its own range inside the
    copy, and decode's CUDA API calls are read under its range by the
    benchmark's readers (two synchronising constant copies a batch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from alluxio_tpu_torch.client.cache.hbm_store import host_to_device
    from alluxio_tpu_torch.ops.decode import decode_image_records
    from alluxio_tpu_torch.utils.tracing import annotate
    from benchmark import devtrace, harness

    card = torch.device("cuda", 0)
    host = np.random.default_rng(3).integers(0, 256, size=8 << 20,
                                             dtype=np.uint8)
    recs, _, _ = _records(n=64, h=32, w=32)
    recs = recs.to(card)
    for _ in range(2):  # warm every path before the slice
        host_to_device(host, card)
        decode_image_records(recs, height=32, width=32, channels=3)
    devtrace.Slice.warm_up(card)
    sl = devtrace.Slice(str(tmp_path))
    sl.start(card)
    for _ in range(3):
        with annotate("atpu.loader.h2d"):
            back = host_to_device(host, card)
        decode_image_records(recs, height=32, width=32, channels=3)
    events = sl.stop(card)
    assert torch.equal(back.cpu(), torch.from_numpy(host))
    run = harness.Run(cfg={}, setup_s=0.0, window_s=1.0, samples=0, steps=0,
                      wait_s=0.0, intervals_ms=[], counters={}, events=events)

    def read(name):
        return harness.plugin("metrics", name).read(run)

    h2d = read("h2d_ms_per_block")
    alloc, copy = read("h2d_stage_alloc_ms_per_block"), \
        read("h2d_stage_copy_ms_per_block")
    assert len(devtrace.ranges(events, "atpu.h2d.stage_alloc")) == 3
    assert 0 < alloc and 0 < copy and alloc + copy <= h2d
    assert 5 <= read("decode_launches_per_batch") <= 40
    assert read("decode_sync_ms_per_batch") > 0
