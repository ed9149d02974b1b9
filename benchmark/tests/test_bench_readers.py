"""Each metric reader on a canned window: a profiler event list in the
Chrome trace's form and a counter snapshot."""

import pytest

from benchmark import devtrace, harness, roofline
from benchmark.harness import Run

CFG = {"batch_size": 400, "stored_record_bytes": 150532, "height": 224,
       "width": 224, "channels": 3, "label_bytes": 4}


def ev(name, cat, ts, dur, tid=1, corr=None):
    return {"name": name, "cat": cat, "ts": float(ts), "dur": float(dur),
            "pid": 0, "tid": tid, "correlation": corr}


def canned_events():
    """A 1000 us slice: two decode ranges launching two kernels each,
    two ranges of another step, a producer's host reads on thread 2 and
    the consumer's copies, and idle time between."""
    return [
        ev(devtrace.SLICE, "user_annotation", 0, 1000),
        ev("bench.wait", "user_annotation", 0, 90),
        ev("atpu.loader.h2d", "user_annotation", 10, 60),
        ev("atpu.loader.host_read", "user_annotation", 0, 40, tid=2),
        ev("atpu.loader.host_read", "user_annotation", 300, 80, tid=2),
        ev("bench.decode", "user_annotation", 100, 50),
        ev("cudaLaunchKernel", "cuda_runtime", 110, 5, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 120, 5, corr=2),
        ev("bench.decode", "user_annotation", 400, 50),
        ev("cudaLaunchKernel", "cuda_runtime", 410, 5, corr=3),
        ev("cudaLaunchKernel", "cuda_runtime", 420, 5, corr=4),
        ev("bench.step", "user_annotation", 600, 30),
        ev("cudaLaunchKernel", "cuda_runtime", 605, 5, corr=5),
        ev("bench.step", "user_annotation", 700, 40),
        ev("cudaLaunchKernel", "cuda_runtime", 705, 5, corr=6),
        ev("cudaMemcpyAsync", "cuda_runtime", 20, 5, corr=7),
        ev("elementwise", "kernel", 150, 100, tid=7, corr=1),
        ev("elementwise", "kernel", 250, 100, tid=7, corr=2),
        ev("elementwise", "kernel", 450, 200, tid=7, corr=3),
        ev("to_bf16", "kernel", 650, 20, tid=7, corr=4),
        ev("step_kernel", "kernel", 680, 25, tid=7,
           corr=5),
        ev("step_kernel", "kernel", 760, 2, tid=7,
           corr=6),
        ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 30, 40, tid=8,
           corr=7),
    ]


def run_with(events=None, counters=None, **kw):
    base = dict(cfg=CFG, setup_s=12.5, window_s=10.0,
                samples=400000, steps=1000, wait_s=2.5,
                intervals_ms=[1.0] * 95 + [3.0] * 5, counters=counters or {},
                events=events)
    base.update(kw)
    return Run(**base)


def read(name, run):
    return harness.plugin("metrics", name).read(run)


def test_host_clock_readers():
    run = run_with()
    assert read("samples_per_s.stream", run) == 40000.0
    assert read("setup_s", run) == 12.5
    assert read("consumer_wait_pct", run) == 25.0
    assert read("batch_interval_p95_ms.stream", run) == pytest.approx(1.0 + 2 * 0.05)
    assert read("batch_interval_p95_ms.stream", run_with(intervals_ms=[1.0])) is None


def test_device_memory_reader():
    assert read("device_memory_peak_gb", run_with(peak_bytes=1394404352)) \
        == pytest.approx(1.394404352)
    # a run without a card has no device memory to read, never a 0
    assert read("device_memory_peak_gb", run_with()) is None


def test_counter_readers():
    c = {"Client.InputStallCount.hbm": 30, "Client.InputStallCount.shm": 70,
         "Client.JaxHbmHits": 33}
    run = run_with(counters=c)
    assert read("device_tier_hit_pct", run) == 30.0
    assert read("device_tier_hit_pct", run_with()) is None


def test_span_readers():
    run = run_with(events=canned_events())
    assert read("host_read_ms_per_block", run) == pytest.approx(0.060)
    assert read("h2d_ms_per_block", run) == pytest.approx(0.060)
    assert read("host_read_ms_per_block", run_with()) is None


def test_device_readers():
    run = run_with(events=canned_events())
    # busy: [30,70] [150,350] [450,670] [680,705] [760,762]
    # -> 40 + 200 + 220 + 25 + 2 = 487 of 1000 us
    assert read("device_idle_pct", run) == pytest.approx(100 * (1 - 0.487))
    per_batch = roofline.decode_bytes(400, 150532, 224 * 224 * 3, 4)
    want = 100 * roofline.bound_s(2 * per_batch) / 420e-6
    assert read("decode_roofline_pct", run) == pytest.approx(want)
    for name in ("device_idle_pct", "decode_roofline_pct"):
        assert read(name, run_with()) is None
        # a slice with no device work gives nothing, never a 0 share
        quiet = [e for e in canned_events() if e["cat"] not in
                 devtrace.DEVICE_CATS]
        assert read(name, run_with(events=quiet)) is None


def test_breakdown_names_ops_and_what_the_host_did_in_the_gaps():
    bd = devtrace.breakdown(canned_events())
    ops = dict(bd["device_ops"])
    assert ops["elementwise"] == pytest.approx(400e-6)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    gaps = dict(bd["idle_gaps"])
    # [0,30] under wait, h2d and a host read; [70,150] and [350,450]
    # with a decode open at their middles; [705,760] under the second
    # step; [670,680] and [762,1000] under none
    assert gaps["atpu.loader.h2d+atpu.loader.host_read+bench.wait"] == \
        pytest.approx(30e-6)
    assert gaps["bench.decode"] == pytest.approx(180e-6)
    assert gaps["bench.step"] == pytest.approx(55e-6)
    assert gaps["other"] == pytest.approx(248e-6)
    assert sum(gaps.values()) == pytest.approx(513e-6)


def test_events_of_keeps_complete_events_only():
    trace = {"traceEvents": [
        {"ph": "X", "name": "k", "cat": "kernel", "ts": 1, "dur": 2,
         "pid": 0, "tid": 7, "args": {"correlation": 9}},
        {"ph": "s", "name": "flow", "cat": "ac2g", "ts": 1},
        {"ph": "i", "name": "marker", "ts": 3}]}
    evs = devtrace.events_of(trace)
    assert evs == [{"name": "k", "cat": "kernel", "ts": 1.0, "dur": 2.0,
                    "pid": 0, "tid": 7, "correlation": 9}]
