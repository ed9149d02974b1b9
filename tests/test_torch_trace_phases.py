"""The three trace phases the port's read path emits where the JAX
package does, on the CPU:

- ``serialize`` on a traced cancellable stream (``RpcChannel.open_stream``
  packs the request eagerly and ``StreamCall`` flushes the decode time
  when iteration ends);
- ``batch_read`` on the worker's ``read_many``;
- ``native_exec`` around the fast path's ``native.exec_plan``.

Each case sends one traced call through each package's RPC stack (a
``LocalCluster`` of the package) or through each package's fast path,
then compares the phase names each span carries and the phase keys that
each package's critical-path analyzer (``utils/critical_path.py``)
attributes. Timing values are not compared. Both tracers are process
singletons: every case restores them.
"""

import importlib

import numpy as np
import pytest

from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES
ROOT_SPAN = "test.phase-root"


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _restore_tracers():
    saved = []
    for pkg in PACKAGES:
        t = _mod(pkg, "utils.tracing").tracer()
        saved.append((t, t.enabled, t.sample_rate, t._ring.maxlen))
    yield
    for t, enabled, rate, cap in saved:
        t.configure(capacity=cap, sample_rate=rate)
        t.enabled = enabled
        t.clear()


def _traced(pkg: str, call):
    """``call()`` under a root span with tracing on; returns the spans
    of the root's trace."""
    tr = _mod(pkg, "utils.tracing")
    tr.set_tracing_enabled(True)
    tr.tracer().clear()
    try:
        with tr.tracer().span(ROOT_SPAN) as root:
            call()
        spans = tr.tracer().snapshot(limit=1000)
    finally:
        tr.set_tracing_enabled(False)
    return [s for s in spans if s["trace_id"] == root.trace_id]


def _view(pkg: str, spans: list) -> tuple:
    """(span name -> sorted phase names, the analyzer's attributed phase
    keys): ``span/phase`` segments, without the unattributed ``/self``."""
    phases = {}
    for s in spans:
        names = sorted({n for n, _ in (s.get("phases") or ())})
        phases.setdefault(s["name"], set()).update(names)
    report = _mod(pkg, "utils.critical_path").analyze_trace(spans)
    keys = sorted(k for k in report["segments"] if not k.endswith("/self"))
    return {k: sorted(v) for k, v in phases.items()}, keys


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """One LocalCluster a package, each holding the same cached file."""
    data = np.random.default_rng(17).integers(
        0, 256, 3 << 20, dtype=np.uint8).tobytes()
    out = {}
    try:
        for pkg in PACKAGES:
            c = _mod(pkg, "minicluster").LocalCluster(
                str(tmp_path_factory.mktemp(pkg)), num_workers=1,
                block_size=4 << 20).start()
            fs = c.file_system()
            fs.write_all("/phases/f", data, write_type="MUST_CACHE")
            bid = c.fs_client().get_file_block_info_list(
                "/phases/f")[0].block_info.block_id
            client = _mod(pkg, "rpc.clients").WorkerClient(
                c.workers[0].address)
            out[pkg] = (c, fs, client, bid)
        yield out, data
    finally:
        for c, fs, _, _ in out.values():
            fs.close()
            c.stop()


def _both(case):
    return {pkg: _view(pkg, _traced(pkg, lambda p=pkg: case(p)))
            for pkg in PACKAGES}


def test_traced_stream_records_serialize(clusters):
    got_data = {}
    handles, data = clusters

    def case(pkg):
        _, _, client, bid = handles[pkg]
        stream = client.read_block_stream(bid, offset=0, length=1 << 20,
                                          chunk_size=256 << 10)
        got_data[pkg] = b"".join(m["data"] for m in stream)

    got = _both(case)
    assert got[PORT] == got[JAX]
    phases, keys = got[PORT]
    assert "serialize" in phases[ROOT_SPAN]
    assert f"{ROOT_SPAN}/serialize" in keys
    assert got_data[PORT] == got_data[JAX] == data[:1 << 20]


def test_untraced_stream_is_unchanged(clusters):
    """With no live span the stream records nothing and reads the same
    bytes."""
    handles, data = clusters
    for pkg in PACKAGES:
        _, _, client, bid = handles[pkg]
        tr = _mod(pkg, "utils.tracing")
        tr.tracer().clear()
        stream = client.read_block_stream(bid, offset=4096, length=8192)
        assert stream._span is None and stream._decode_cell is None
        assert b"".join(m["data"] for m in stream) == data[4096:12288]
        assert tr.tracer().snapshot() == []


def test_read_many_records_batch_read(clusters):
    handles, data = clusters
    batches = {}

    def case(pkg):
        _, _, client, bid = handles[pkg]
        batches[pkg] = client.read_many(bid, [0, 100, 5000], [10, 20, 4096])

    got = _both(case)
    assert got[PORT] == got[JAX]
    phases, keys = got[PORT]
    server = "atpu.BlockWorker.read_many"
    assert "batch_read" in phases[server]
    assert f"{server}/batch_read" in keys
    assert batches[PORT]["lengths"] == batches[JAX]["lengths"] == \
        [10, 20, 4096]
    assert batches[PORT]["data"] == batches[JAX]["data"] == \
        data[0:10] + data[100:120] + data[5000:9096]


def test_fast_path_records_native_exec():
    src = np.random.default_rng(5).integers(0, 256, 96 << 10,
                                            dtype=np.uint8).tobytes()
    dests = {}

    def case(pkg):
        dest = bytearray(128 << 10)
        assert _mod(pkg, "client.fastpath").copy_into(dest, 5000, src)
        dests[pkg] = dest

    got = _both(case)
    assert got[PORT] == got[JAX]
    phases, keys = got[PORT]
    assert phases[ROOT_SPAN] == ["native_exec"]
    assert keys == [f"{ROOT_SPAN}/native_exec"]
    assert dests[PORT] == dests[JAX]
