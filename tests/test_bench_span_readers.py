"""The benchmark's readers of the port's read-path spans and counters
(``benchmark/metrics/``), on canned windows in the Chrome trace's form as
``benchmark/tests/test_bench_readers.py`` builds them, and one tiny
traced run of the harness on the CPU that reads them from the port."""

import pytest

pytest.importorskip("torch")

from benchmark import devtrace, harness  # noqa: E402
from benchmark.harness import Run  # noqa: E402
from benchmark.tests.conftest import (  # noqa: E402,F401
    run_tiny, tiny_base, tiny_bench,
)

SPAN_READERS = ("host_view_ms_per_block", "host_prefault_ms_per_block",
                "h2d_stage_alloc_ms_per_block", "h2d_stage_copy_ms_per_block",
                "loader_queue_wait_pct", "producer_blocked_pct")
DECODE_READERS = ("decode_launches_per_batch", "decode_sync_ms_per_batch")
NEW = SPAN_READERS + ("device_tier_evictions_per_block",) + DECODE_READERS


def ev(name, cat, ts, dur, tid=1, corr=None):
    return {"name": name, "cat": cat, "ts": float(ts), "dur": float(dur),
            "pid": 0, "tid": tid, "correlation": corr}


def rng(name, ts, dur, tid=1):
    return ev(name, "user_annotation", ts, dur, tid)


def api(name, ts, dur, tid=1, corr=None):
    return ev(name, "cuda_runtime", ts, dur, tid, corr)


def canned_events():
    """A 1000 us slice. The consumer (thread 1) waits on the queue twice,
    copies two blocks and decodes two batches; the producer (thread 2)
    reads two blocks and hands them over, one hand-over running past the
    slice's end; a third thread makes CUDA calls during a decode."""
    return [
        rng(devtrace.SLICE, 0, 1000),
        rng("atpu.loader.queue_wait", 0, 100),
        rng("atpu.loader.h2d", 100, 200),
        rng("atpu.h2d.stage_alloc", 110, 40),
        rng("atpu.h2d.stage_copy", 150, 140),
        api("cudaMemcpyAsync", 292, 4, corr=1),
        rng("atpu.loader.queue_wait", 500, 50),
        rng("atpu.loader.h2d", 550, 100),
        rng("atpu.h2d.stage_alloc", 555, 20),
        rng("atpu.h2d.stage_copy", 575, 60),
        rng("atpu.loader.host_read", 0, 50, tid=2),
        rng("atpu.loader.view", 0, 10, tid=2),
        rng("atpu.loader.prefault", 10, 38, tid=2),
        rng("atpu.loader.queue_put", 50, 400, tid=2),
        rng("atpu.loader.host_read", 460, 30, tid=2),
        rng("atpu.loader.view", 460, 6, tid=2),
        rng("atpu.loader.prefault", 466, 22, tid=2),
        rng("atpu.loader.queue_put", 900, 300, tid=2),
        # batch 1: three launches, two constant copies, each followed by
        # a stream sync, a memset and a query that is neither
        rng("atpu.decode.images", 700, 100),
        api("cudaLaunchKernel", 705, 3, corr=2),
        api("cudaLaunchKernel", 710, 3, corr=3),
        api("cudaMemcpyAsync", 715, 4, corr=4),
        api("cudaStreamSynchronize", 720, 10),
        api("cudaMemcpyAsync", 735, 4, corr=5),
        api("cudaStreamSynchronize", 740, 20),
        api("cudaMemsetAsync", 765, 2, corr=6),
        api("cudaLaunchKernel", 770, 3, corr=7),
        api("cudaGetDevice", 775, 1),
        # batch 2: two launches and a blocking copy
        rng("atpu.decode.images", 850, 100),
        api("cudaLaunchKernel", 855, 3, corr=8),
        api("cudaMemcpy", 860, 15, corr=9),
        api("cudaLaunchKernel", 880, 3, corr=10),
        # outside every decode range, or on another thread: not counted
        api("cudaLaunchKernel", 820, 3, corr=11),
        api("cudaStreamSynchronize", 730, 50, tid=3),
        api("cudaLaunchKernel", 860, 3, tid=3, corr=12),
        ev("elementwise", "kernel", 720, 30, tid=7, corr=2),
    ]


def run_with(events=None, counters=None):
    return Run(cfg={}, setup_s=12.5, window_s=10.0, samples=400000,
               steps=1000, wait_s=2.5, intervals_ms=[1.0] * 10,
               counters=counters or {}, events=events)


def read(name, run):
    return harness.plugin("metrics", name).read(run)


def test_every_new_reader_is_declared_for_the_cell():
    bench = harness.load_bench()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["workloads"] == ["resnet50.stream"]
        assert m["moves"] == "device_memory_peak_gb"
    assert declared["producer_blocked_pct"]["better"] == "higher"
    assert declared["device_tier_evictions_per_block"]["source"] == \
        "program_counter"


def test_step_readers_take_the_mean_of_their_ranges():
    run = run_with(events=canned_events())
    assert read("host_view_ms_per_block", run) == pytest.approx(0.008)
    assert read("host_prefault_ms_per_block", run) == pytest.approx(0.030)
    assert read("h2d_stage_alloc_ms_per_block", run) == pytest.approx(0.030)
    assert read("h2d_stage_copy_ms_per_block", run) == pytest.approx(0.100)
    # the parent's ranges alone, as the older readers see them
    assert read("h2d_ms_per_block", run) == pytest.approx(0.150)
    assert read("host_read_ms_per_block", run) == pytest.approx(0.040)


def test_queue_readers_share_the_slice_clipped_to_it():
    run = run_with(events=canned_events())
    assert read("loader_queue_wait_pct", run) == pytest.approx(15.0)
    # 400 us, then 100 of the 300 that lie inside the slice
    assert read("producer_blocked_pct", run) == pytest.approx(50.0)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_span_reader_reads_nothing_without_its_ranges(name):
    assert read(name, run_with()) is None
    parent = [e for e in canned_events()
              if not e["name"].startswith(("atpu.h2d.", "atpu.loader.view",
                                           "atpu.loader.prefault",
                                           "atpu.loader.queue_"))]
    assert read(name, run_with(events=parent)) is None


def test_queue_readers_need_the_slice():
    no_slice = [e for e in canned_events() if e["name"] != devtrace.SLICE]
    for name in ("loader_queue_wait_pct", "producer_blocked_pct"):
        assert read(name, run_with(events=no_slice)) is None


@pytest.mark.parametrize("counters,want", [
    ({"Client.HbmEvictions": 32, "Client.InputStallCount.shm": 33}, 32 / 33),
    ({"Client.HbmEvictions": 0, "Client.InputStallCount.hbm": 5}, 0.0),
    ({"Client.HbmEvictions": 3, "Client.InputStallCount.hbm": 1,
      "Client.InputStallCount.shm": 2, "Client.InputStallCount.ufs": 1}, 0.75),
    # the parent, which has no such counter
    ({"Client.InputStallCount.shm": 33}, None),
    # no block taken
    ({"Client.HbmEvictions": 4}, None),
])
def test_evictions_per_block(counters, want):
    got = read("device_tier_evictions_per_block", run_with(counters=counters))
    assert got == (want if want is None else pytest.approx(want))


def test_decode_readers_count_the_calls_under_each_range():
    run = run_with(events=canned_events())
    # batch 1: 3 launches, 2 copies, 1 memset; batch 2: 2 launches, 1 copy
    assert read("decode_launches_per_batch", run) == pytest.approx(9 / 2)
    # two stream syncs (10 + 20 us) and one blocking copy (15 us)
    assert read("decode_sync_ms_per_batch", run) == pytest.approx(0.045 / 2)


def test_decode_sync_reads_zero_when_decode_never_waits():
    quiet = [e for e in canned_events() if e["name"] not in
             ("cudaStreamSynchronize", "cudaMemcpy")]
    assert read("decode_sync_ms_per_batch", run_with(events=quiet)) == 0.0
    assert read("decode_launches_per_batch", run_with(events=quiet)) == \
        pytest.approx(8 / 2)


@pytest.mark.parametrize("name", DECODE_READERS)
def test_decode_readers_read_nothing_without_a_range_or_a_card(name):
    assert read(name, run_with()) is None
    # the parent: CUDA calls, but no decode range
    parent = [e for e in canned_events() if e["name"] != "atpu.decode.images"]
    assert read(name, run_with(events=parent)) is None
    # a CPU profile: decode ranges, no CUDA call
    cpu = [e for e in canned_events()
           if not e["cat"].startswith(devtrace.LAUNCH_PREFIX)]
    assert read(name, run_with(events=cpu)) is None


def test_breakdown_names_the_copy_step_an_idle_gap_falls_under():
    bd = devtrace.breakdown(canned_events())
    gaps = dict(bd["idle_gaps"])
    # the device idles but for [720, 750]: the first gap's middle falls
    # in the producer's hand-over, the second's in a decode
    assert gaps == {"atpu.loader.queue_put": pytest.approx(720e-6),
                    "atpu.decode.images": pytest.approx(250e-6)}


def test_a_traced_cpu_run_reads_the_port_spans_and_counter(tiny_base,
                                                           tiny_bench):
    """The tiny stream cell traced on the CPU: the port's step ranges and
    the eviction counter are read; the pinned staging and decode's CUDA
    calls are not (no card)."""
    res, line = run_tiny(tiny_bench, tiny_base, "tinyimg.stream", trace=True)
    assert line["correct"], line["checks"]
    got = line["metrics"]
    on_cpu = set(SPAN_READERS) - {"h2d_stage_alloc_ms_per_block"}
    for name in on_cpu | {"device_tier_evictions_per_block"}:
        assert name in got, name
        assert got[name]["value"] >= 0
    assert not (set(NEW) - on_cpu - {"device_tier_evictions_per_block"}) \
        & set(got)
    assert got["h2d_stage_copy_ms_per_block"]["value"] <= \
        got["h2d_ms_per_block"]["value"]
    assert got["host_view_ms_per_block"]["value"] + \
        got["host_prefault_ms_per_block"]["value"] <= \
        got["host_read_ms_per_block"]["value"]
    assert 0 < got["device_tier_evictions_per_block"]["value"] <= 1.0
