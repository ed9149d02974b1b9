"""The port's trace context and sampling against the JAX package's, on
the CPU.

- ``format_traceparent`` / ``parse_traceparent`` give the same strings
  and contexts on both packages, and both reject the same malformed
  headers;
- ``atpu.trace.sample.rate`` at 0 and at 1 and ``atpu.trace.ring.capacity``
  (through ``apply_trace_conf``) record the same spans on both; a child
  span, local or under a bound remote parent, inherits its root's
  decision;
- over a ``LocalCluster`` of each package, the worker's gRPC span and the
  master's fast-path spans carry the client span's trace id;
- ``device_trace`` writes a Chrome trace file on the CPU.

Both tracers are process singletons: every case restores them.
"""

import importlib
import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")


def _tracing(pkg: str):
    return importlib.import_module(f"{pkg}.utils.tracing")


@pytest.fixture(autouse=True)
def _restore_tracers():
    saved = []
    for pkg in PACKAGES:
        t = _tracing(pkg).tracer()
        saved.append((t, t.enabled, t.sample_rate, t._ring.maxlen))
    yield
    for t, enabled, rate, cap in saved:
        t.configure(capacity=cap, sample_rate=rate)
        t.enabled = enabled
        t.clear()


CONTEXTS = [("4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7", True),
            ("0" * 31 + "1", "0" * 15 + "1", False),
            ("f" * 32, "a" * 16, True)]


@pytest.mark.parametrize("ctx", CONTEXTS)
def test_traceparent_round_trip_matches_jax(ctx):
    out = []
    for pkg in PACKAGES:
        tr = _tracing(pkg)
        text = tr.format_traceparent(tr.TraceContext(*ctx))
        out.append((text, tuple(tr.parse_traceparent(text))))
    assert out[0] == out[1]
    assert out[1][1] == ctx


@pytest.mark.parametrize("header", [
    None, "", "garbage", "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01-extra",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-" + "0" * 32 + "-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-" + "0" * 16 + "-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902bz-01",
    " 00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-03 ",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-02",
])
def test_parse_traceparent_rejects_like_jax(header):
    got = [_tracing(pkg).parse_traceparent(header) for pkg in PACKAGES]
    assert (tuple(got[0]) if got[0] else None) == \
        (tuple(got[1]) if got[1] else None)


def _apply(pkg: str, rate: float, capacity: int) -> None:
    conf = importlib.import_module(f"{pkg}.conf").Configuration(
        {"atpu.trace.sample.rate": rate,
         "atpu.trace.ring.capacity": capacity}, load_env=False)
    tr = _tracing(pkg)
    tr.apply_trace_conf(conf)
    tr.set_tracing_enabled(True)
    tr.tracer().clear()


def _roots_with_children(pkg: str, n: int) -> list:
    """``n`` root spans, each with one child; the names recorded."""
    t = _tracing(pkg).tracer()
    for i in range(n):
        with t.span(f"root-{i}"):
            with t.span(f"child-{i}"):
                pass
    return sorted(s["name"] for s in t.snapshot(limit=1 << 12))


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_sample_rate_matches_jax(rate):
    got = []
    for pkg in PACKAGES:
        _apply(pkg, rate, 4096)
        got.append((_tracing(pkg).tracer().sample_rate,
                    _roots_with_children(pkg, 10)))
    assert got[0] == got[1]
    assert len(got[1][1]) == (20 if rate == 1.0 else 0)


def test_half_rate_keeps_or_drops_whole_traces():
    """At rate 0.5 each root's decision covers its child: the recorded
    names come in (root, child) pairs on both packages."""
    for pkg in PACKAGES:
        _apply(pkg, 0.5, 4096)
        names = _roots_with_children(pkg, 200)
        roots = {n.split("-")[1] for n in names if n.startswith("root")}
        children = {n.split("-")[1] for n in names if n.startswith("child")}
        assert roots == children
        assert 0 < len(roots) < 200


@pytest.mark.parametrize("capacity", [1, 5, 64])
def test_ring_capacity_matches_jax(capacity):
    got = []
    for pkg in PACKAGES:
        _apply(pkg, 1.0, capacity)
        got.append((_tracing(pkg).tracer()._ring.maxlen,
                    _roots_with_children(pkg, 40)))
    assert got[0] == got[1]
    assert len(got[1][1]) == capacity


@pytest.mark.parametrize("sampled", [True, False])
def test_remote_child_inherits_the_decision(sampled):
    """Under a bound remote parent the span joins its trace and takes its
    sampled flag whatever the local rate; outside it the local rate
    decides again."""
    got = []
    for pkg in PACKAGES:
        tr = _tracing(pkg)
        _apply(pkg, 0.0 if sampled else 1.0, 4096)
        header = tr.format_traceparent(tr.TraceContext(
            "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7", sampled))
        token = tr.bind_remote_parent(header)
        try:
            assert tr.current_traceparent() == header
            with tr.tracer().span("server") as sp:
                inner = tr.current_traceparent()
        finally:
            tr.reset_remote_parent(token)
        with tr.tracer().span("after"):
            pass
        spans = tr.tracer().snapshot()
        got.append(([(s["name"], s["trace_id"], s["parent"])
                     for s in spans], sp.sampled, inner.split("-")[1],
                    inner.split("-")[3]))
    assert got[0][1:] == got[1][1:]
    assert [n for n, _, _ in got[0][0]] == [n for n, _, _ in got[1][0]]
    want = [("server", "4bf92f3577b34da6a3ce929d0e0e4736",
             "00f067aa0ba902b7")] if sampled else []
    assert [s for s in got[1][0] if s[0] == "server"] == want


@pytest.mark.parametrize("pkg", PACKAGES)
def test_worker_and_master_spans_join_the_client_trace(pkg, tmp_path):
    """A client span around a ``get_status`` and a ``read_all`` on a
    LocalCluster: the worker's SHM lease RPC (gRPC) and the master's
    metadata calls (the same-host fast path's threads) each open a
    server span in the client span's trace."""
    tr = _tracing(pkg)
    mc = importlib.import_module(f"{pkg}.minicluster")
    with mc.LocalCluster(str(tmp_path), num_workers=1) as c:
        fs = c.file_system()
        try:
            fs.write_all("/t/f", b"x" * 100_000)
            tr.set_tracing_enabled(True)
            tr.tracer().clear()
            with tr.tracer().span("test.root") as root:
                fs.get_status("/t/f")
                fs.read_all("/t/f")
            spans = tr.tracer().snapshot(limit=1000)
        finally:
            tr.set_tracing_enabled(False)
            fs.close()
    joined = {(s["name"], "process_request" in s["thread"])
              for s in spans if s["trace_id"] == root.trace_id}
    assert ("atpu.BlockWorker.shm_open", False) in joined
    assert ("atpu.FileSystemMaster.get_status", True) in joined


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import torch

    from alluxio_tpu_torch.utils.tracing import annotate, device_trace

    with device_trace(str(tmp_path / "traces")) as t:
        with annotate("test.region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert t.path is not None and t.path.startswith(str(tmp_path))
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "test.region" for e in events)
    assert t.profile.key_averages()
