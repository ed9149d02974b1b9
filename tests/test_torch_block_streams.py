"""The port's block streams against the JAX package's, on the CPU.

The same seeded bytes go out through each package's ``GrpcBlockOutStream``
and ``LocalBlockOutStream`` and come back through its ``GrpcBlockInStream``
and its lease-form ``LocalBlockInStream``, each package with its own
``WorkerClient``, against a JAX worker and against the port's worker (in a
JAX ``LocalCluster``, ``tests/testutils/torch_worker.py``): the same bytes,
lengths, serving sources and typed errors (held by class name).

Where the port departs from the JAX streams on purpose, the port's side is
held alone:

- ``GrpcBlockOutStream.close(cancel=True)`` sends the worker a cancel
  message, so the worker aborts the temp block. The JAX stream ends the
  stream instead, which commits the bytes sent so far.
- ``written`` counts bytes for any buffer, so a numpy array of a dtype
  wider than one byte writes whole; the JAX streams count ``len(data)``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu.client import block_streams as jax_streams  # noqa: E402
from alluxio_tpu.conf import Keys as JaxKeys  # noqa: E402
from alluxio_tpu.minicluster import LocalCluster  # noqa: E402
from alluxio_tpu.rpc.clients import WorkerClient as JaxWorkerClient  # noqa: E402
from alluxio_tpu_torch.client import block_streams as streams  # noqa: E402
from alluxio_tpu_torch.rpc.clients import WorkerClient  # noqa: E402
from alluxio_tpu_torch.utils import ids  # noqa: E402
from tests.testutils.torch_worker import (PortWorker,  # noqa: E402
                                          lease_loader_case)

BLOCK = 64 * 1024


@pytest.fixture(params=["jax", "port"])
def worker(request, tmp_path):
    """(address, store) of a JAX worker or of the port's worker, each the
    one worker of a JAX cluster."""
    with LocalCluster(str(tmp_path), num_workers=1 if request.param == "jax"
                      else 0, block_size=BLOCK,
                      conf_overrides={JaxKeys.USER_SHM_ENABLED: False}
                      ) as cluster:
        if request.param == "jax":
            w = cluster.workers[0]
            yield w.address, w.worker.store
            return
        pw = PortWorker(cluster, str(tmp_path))
        try:
            yield f"localhost:{pw.port}", pw.worker.store
        finally:
            pw.stop()


def _payload(seed: int, nbytes: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the class is the observation
        return ("error", type(e).__name__)


def _script(mod, client, session, base):
    """One package's streams through its own client; block ids of their
    own per package. Returns what a caller can observe."""
    a, b, c = (ids.block_id(base + i, 0) for i in range(3))
    raw = _payload(base, BLOCK + 4097)

    def grpc_write(bid, parts):
        out = mod.GrpcBlockOutStream(client, session, bid, chunk_size=4096)
        for part in parts:
            out.write(part)
        out.close()
        return out.written

    def grpc_read():
        ins = mod.GrpcBlockInStream(client, a, len(raw), chunk_size=8192)
        got = (ins.read_all() == raw, ins.pread(100, 300) == raw[100:400],
               ins.pread(len(raw) - 10, 99) == raw[-10:],
               bytes(ins.read_all_view()) == raw, ins.last_source,
               ins.source_bucket(), ins.is_ufs_fallback)
        ins.close()
        return got

    def local_write(bid, cancel=False):
        out = mod.LocalBlockOutStream(client, session, bid,
                                      size_hint=len(raw))
        out.write(raw[:5000])
        out.write(raw[5000:])
        out.close(cancel=cancel)
        return out.written

    def local_read():
        with mod.LocalBlockInStream(client, session, b) as ins:
            return (ins.length, ins.read_all() == raw,
                    ins.pread(7, 70) == raw[7:77],
                    ins.numpy_view().tobytes() == raw, ins.last_source,
                    ins.source_bucket())

    return {"grpc_write": _outcome(lambda: grpc_write(
                a, [raw[:3], raw[3:BLOCK], raw[BLOCK:]])),
            "grpc_read": _outcome(grpc_read),
            "grpc_rewrite": _outcome(lambda: grpc_write(a, [raw])),
            "grpc_read_absent": _outcome(lambda: mod.GrpcBlockInStream(
                client, c, 10).read_all()),
            "local_write": _outcome(lambda: local_write(b)),
            "local_read": _outcome(local_read),
            "local_read_absent": _outcome(lambda: mod.LocalBlockInStream(
                client, session, c)),
            "local_cancel": _outcome(lambda: local_write(c, cancel=True)),
            "local_cancelled_absent": _outcome(
                lambda: mod.LocalBlockInStream(client, session, c))}


def test_streams_match_jax_streams(worker):
    address, store = worker
    session = ids.create_session_id()
    want = _script(jax_streams, JaxWorkerClient(address), session, 1000)
    got = _script(streams, WorkerClient(address), session, 2000)
    assert got == want
    assert want["grpc_write"] == ("ok", BLOCK + 4097)
    assert want["grpc_read"][1][4] != "UFS"
    assert want["grpc_rewrite"] == ("error", "AlreadyExistsError")
    assert want["local_read_absent"] == ("error", "BlockDoesNotExistError")
    assert want["local_cancelled_absent"] == want["local_read_absent"]
    for base in (1000, 2000):
        assert [store.has_block(ids.block_id(base + i, 0))
                for i in range(3)] == [True, True, False]


def test_grpc_out_stream_cancel_aborts(worker):
    """A cancelled remote write leaves no block behind (the worker gets
    the cancel message and aborts), the id is free to write again, and a
    full write of the same bytes then reads back whole."""
    address, store = worker
    client, session = WorkerClient(address), ids.create_session_id()
    bid, raw = ids.block_id(3000, 0), _payload(3, 3 * BLOCK)
    out = streams.GrpcBlockOutStream(client, session, bid, chunk_size=4096)
    out.write(raw[:BLOCK])
    out.close(cancel=True)
    assert out.written == BLOCK
    assert not store.has_block(bid)
    with streams.GrpcBlockOutStream(client, session, bid) as out:
        out.write(raw)
    assert store.has_block(bid)
    assert streams.GrpcBlockInStream(client, bid, len(raw)).read_all() == raw
    # an exception inside the with-block cancels too
    other = ids.block_id(3001, 0)
    with pytest.raises(RuntimeError):
        with streams.GrpcBlockOutStream(client, session, other) as out:
            out.write(raw[:100])
            raise RuntimeError("producer failed")
    assert not store.has_block(other)


@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_wide_dtype_writes_whole(worker, dtype):
    """A numpy array of a dtype wider than one byte goes out through the
    port's streams whole, and reads back as the bytes that the JAX
    streams write for ``arr.tobytes()``."""
    address, _ = worker
    session = ids.create_session_id()
    arr = np.random.default_rng(9).standard_normal(BLOCK // 4 + 3).astype(
        dtype)
    out_bytes = {}
    for name, mod, client, data, base in (
            ("jax", jax_streams, JaxWorkerClient(address), arr.tobytes(),
             4000),
            ("port", streams, WorkerClient(address), arr, 5000)):
        g, l = ids.block_id(base, 0), ids.block_id(base + 1, 0)
        with mod.GrpcBlockOutStream(client, session, g,
                                    chunk_size=4096) as out:
            out.write(data)
        with mod.LocalBlockOutStream(client, session, l,
                                     size_hint=arr.nbytes) as lout:
            lout.write(data)
        assert out.written == lout.written == arr.nbytes
        out_bytes[name] = (
            mod.GrpcBlockInStream(client, g, arr.nbytes).read_all(),
            client.read_block_bytes(l))
    assert out_bytes["port"] == out_bytes["jax"] == \
        (arr.tobytes(), arr.tobytes())


def test_lease_loader_on_cpu(tmp_path):
    """The card test's lease case on the CPU: blocks written by short
    circuit into the port's worker load through leases, each equal to its
    file, with every lease held across its staging copy."""
    lease_loader_case(tmp_path, "cpu", words=1 << 16)
