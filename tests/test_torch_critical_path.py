"""The port's critical-path analysis and trace stitching against the JAX
package's, on the CPU.

Seeded span lists — nested children, hedged fan-outs (two children of
one parent racing, the later one gating), phases that overlap a child's
interval, spans whose parent was never shipped, children skewed outside
their parent's window, spans without a duration — give equal
``analyze_trace`` and ``profile`` answers in both packages. The master's
``TraceStore`` deduplicates and filters alike, and ``summarize_traces``
and ``stitch_spans`` (the process ring merged with the shipped spans)
give equal views.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES
PHASES = ("queue_wait", "lock_wait", "wire", "tier_read", "ufs_fetch",
          "cache_fill", "device_put", "drain")
NAMES = ("atpu.client.remote_read", "atpu.BlockWorker.read_block",
         "atpu.worker.ufs_fetch", "atpu.FileSystemMaster.get_status")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _trace(rng, trace_id: str, t0: float, sources=("client", "worker")):
    """One seeded trace: a root and up to three levels of children, some
    hedged (two overlapping siblings), some skewed past their parent."""
    spans = []
    counter = [0]

    def new_id():
        counter[0] += 1
        return f"{trace_id[:8]}{counter[0]:08x}"

    def span(name, parent, start, dur, depth):
        sid = new_id()
        phases = [[PHASES[int(rng.integers(len(PHASES)))],
                   round(float(rng.uniform(0.0, dur)), 3)]
                  for _ in range(int(rng.integers(0, 4)))]
        s = {"name": name, "span_id": sid, "parent": parent,
             "trace_id": trace_id, "start_ms": round(start, 3),
             "duration_ms": round(dur, 3),
             "source": sources[min(depth, len(sources) - 1)],
             "tags": {}, "error": None}
        if phases:
            s["phases"] = phases
        spans.append(s)
        if depth < 3:
            for _ in range(int(rng.integers(0, 4))):
                cs = start + float(rng.uniform(-0.1, 0.8)) * dur
                cd = float(rng.uniform(0.05, 0.6)) * dur
                name = NAMES[min(depth + 1, len(NAMES) - 1)]
                span(name, sid, cs, cd, depth + 1)
                if rng.random() < 0.3:  # hedge: a racing sibling
                    span(name, sid, cs + 0.1 * cd,
                         cd * float(rng.uniform(0.5, 1.5)), depth + 1)
        return sid

    span(NAMES[0], None, t0, float(rng.uniform(1.0, 50.0)), 0)
    if rng.random() < 0.3:  # an orphan: its parent was never shipped
        spans.append({"name": NAMES[1], "span_id": new_id(),
                      "parent": "f" * 16, "trace_id": trace_id,
                      "start_ms": t0 + 0.5, "duration_ms": 0.7,
                      "source": "worker", "tags": {}, "error": None})
    if rng.random() < 0.2:  # still open: no duration
        spans.append({"name": NAMES[2], "span_id": new_id(),
                      "parent": spans[0]["span_id"], "trace_id": trace_id,
                      "start_ms": t0 + 0.2, "duration_ms": None,
                      "source": "worker", "tags": {}, "error": None})
    return spans


def _spans(seed: int, traces: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(traces):
        out += _trace(rng, f"{seed:04x}{i:028x}", 1000.0 * i)
    order = rng.permutation(len(out))
    return [out[k] for k in order]


@pytest.mark.parametrize("seed", tuple(range(10)))
def test_analyze_trace_equal(seed):
    spans = _spans(seed, 1)
    got = [_mod(pkg, "utils.critical_path").analyze_trace(
        [dict(s) for s in spans]) for pkg in PACKAGES]
    assert got[1] == got[0]
    assert got[0] is not None and got[0]["chain"]


@pytest.mark.parametrize("kw", (
    {}, {"root_prefix": "atpu.client"}, {"root_prefix": "atpu.nothing"},
    {"max_traces": 3}, {"top": 2}), ids=repr)
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_profile_equal(seed, kw):
    spans = _spans(100 + seed, 12)
    got = [_mod(pkg, "utils.critical_path").profile(
        [dict(s) for s in spans], **kw) for pkg in PACKAGES]
    assert got[1] == got[0]


def test_analyze_trace_without_usable_spans_is_none_alike():
    spans = [{"name": "x", "span_id": "a", "start_ms": None,
              "duration_ms": 1.0}]
    for pkg in PACKAGES:
        cp = _mod(pkg, "utils.critical_path")
        assert cp.analyze_trace(spans) is None
        assert cp.analyze_trace([]) is None


@pytest.mark.parametrize("seed", (0, 1))
def test_trace_store_and_summaries_equal(seed):
    """Ingest the same shipped batches (with repeats and non-dict junk)
    from several sources into a small store; its snapshots by prefix and
    trace id, its span count and the summaries are equal."""
    spans = _spans(200 + seed, 8)
    rng = np.random.default_rng(seed)
    batches = [(f"worker-h{int(rng.integers(3))}:1",
                [spans[int(k)] for k in rng.integers(0, len(spans), 20)]
                + ["junk"]) for _ in range(10)]
    got = {}
    for pkg in PACKAGES:
        tracing = _mod(pkg, "utils.tracing")
        store = tracing.TraceStore(capacity=40)
        added = [store.ingest(src, [dict(s) if isinstance(s, dict) else s
                                    for s in batch])
                 for src, batch in batches]
        tid = spans[0]["trace_id"]
        got[pkg] = (added, store.span_count(), store.snapshot(limit=25),
                    store.snapshot(prefix="atpu.Block"),
                    store.snapshot(trace_id=tid),
                    tracing.summarize_traces(store.snapshot(limit=1000)))
    assert got[PORT] == got[JAX]


def test_stitch_spans_merges_the_ring_and_the_store_alike():
    """The process ring's spans (recorded by each package's tracer) and
    the store's shipped spans merge into one most-recent-first view,
    deduplicated, with per-trace summaries."""
    shipped = _spans(300, 4)
    got = {}
    for pkg in PACKAGES:
        tracing = _mod(pkg, "utils.tracing")
        t = tracing.tracer()
        was = t.enabled
        t.clear()
        try:
            for s in shipped[:6]:  # the master's own ring holds these
                sp = tracing.Span(s["name"], s["span_id"], s["parent"],
                                  s["trace_id"])
                sp.start_ms = s["start_ms"]
                sp.duration_ms = s["duration_ms"]
                sp.thread = "t"
                t.record(sp)
            store = tracing.TraceStore()
            # shipped spans carry no source: the store stamps the
            # heartbeat's
            store.ingest("worker-h0:1", [
                {k: v for k, v in s.items() if k != "source"}
                for s in shipped])
            tid = shipped[0]["trace_id"]
            got[pkg] = (
                tracing.stitch_spans(store, local_source="master"),
                tracing.stitch_spans(store, limit=5, prefix="atpu.Block",
                                     local_source="master"),
                tracing.stitch_spans(store, trace_id=tid,
                                     local_source="master"),
                tracing.stitch_spans(None, local_source="master"))
        finally:
            t.clear()
            t.enabled = was
    assert got[PORT] == got[JAX]
    sources = {s["source"] for s in got[PORT][0]["spans"]}
    assert sources == {"master", "worker-h0:1"}
