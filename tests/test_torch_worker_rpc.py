"""The port's worker on the wire, both ways, on the CPU.

(a) A JAX ``LocalCluster`` with no worker of its own takes the port's
    ``BlockWorker`` behind the port's ``RpcServer``, registered through
    the JAX master clients (``tests/testutils/torch_worker.py``). The
    JAX ``FileSystem`` writes files ``MUST_CACHE`` through it and reads
    them back byte for byte by short circuit and by gRPC; the JAX master sees the block locations; a ``THROUGH`` write
    persists through the port's ``persist_file``, and an ``async_cache``
    of that persisted file lands.
(b) The port's ``WorkerClient`` against a JAX worker, call for call
    beside the JAX ``WorkerClient``: the same results and the same typed
    errors, held by class name.
(c) The port's ``DeviceBlockLoader`` (``device="cpu"``) over the JAX
    ``FileSystem`` served by the port's worker, against the JAX loader:
    the same bytes and the same chained ``scaled_sum``.
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from alluxio_tpu.client.jax_io import \
    DeviceBlockLoader as JaxDeviceBlockLoader  # noqa: E402
from alluxio_tpu.client.streams import WriteType  # noqa: E402
from alluxio_tpu.conf import Keys as JaxKeys  # noqa: E402
from alluxio_tpu.minicluster import LocalCluster  # noqa: E402
from alluxio_tpu.ops import reduce_kernel as jax_rk  # noqa: E402
from alluxio_tpu.rpc.clients import WorkerClient as JaxWorkerClient  # noqa: E402
from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader  # noqa: E402
from alluxio_tpu_torch.ops import reduce_kernel as rk  # noqa: E402
from alluxio_tpu_torch.rpc.clients import WorkerClient  # noqa: E402
from alluxio_tpu_torch.utils import ids  # noqa: E402
from tests.testutils.torch_worker import PortWorker  # noqa: E402

BLOCK = 64 * 1024
SHM_OFF = {JaxKeys.USER_SHM_ENABLED: False}


def _jax_metric(name: str) -> int:
    from alluxio_tpu.metrics import metrics

    return metrics().counter(name).count


@pytest.fixture()
def port_cluster(tmp_path):
    """A JAX cluster whose one worker is the port's."""
    with LocalCluster(str(tmp_path), num_workers=0, block_size=BLOCK,
                      conf_overrides=SHM_OFF) as cluster:
        pw = PortWorker(cluster, str(tmp_path))
        try:
            yield cluster, pw
        finally:
            pw.stop()


def _payload(seed: int, nbytes: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()


def _file_system(cluster, overrides):
    from alluxio_tpu.client.file_system import FileSystem

    conf = cluster.conf.copy()
    for k, v in overrides.items():
        conf.set(k, v)
    return FileSystem(cluster.master.address, conf=conf)


# -- (a) the JAX cluster with the port's worker ------------------------------
def test_jax_client_writes_and_reads_through_port_worker(port_cluster):
    cluster, pw = port_cluster
    fs = cluster.file_system()
    data = {f"/a/f{i}": _payload(i, (2 + i) * BLOCK + 123) for i in range(3)}
    for path, raw in data.items():
        fs.write_all(path, raw, write_type=WriteType.MUST_CACHE)
    # every block is on the port's worker, and the JAX master says so
    bm = cluster.block_client()
    block_ids = [b for p in data for b in fs.get_status(p).block_ids]
    assert sorted(pw.worker.store.block_report()["MEM"]) == sorted(block_ids)
    for bid in block_ids:
        locs = bm.get_block_info(bid).locations
        assert [(l.address.rpc_port, l.tier_alias) for l in locs] == \
            [(pw.port, "MEM")]
    # short circuit (the same host, the worker's shm dir exists)
    opens = _jax_metric("Client.BlockOpens.shm")
    for path, raw in data.items():
        assert fs.read_all(path) == raw
    assert _jax_metric("Client.BlockOpens.shm") - opens == len(block_ids)
    assert pw.worker.store.active_locks() == 0  # every lease released
    # gRPC: the same files with short circuit off
    remote = _file_system(cluster,
                          {JaxKeys.USER_SHORT_CIRCUIT_ENABLED: False})
    opens = _jax_metric("Client.BlockOpens.remote")
    try:
        for path, raw in data.items():
            assert remote.read_all(path) == raw
    finally:
        remote.close()
    assert _jax_metric("Client.BlockOpens.remote") - opens == len(block_ids)


def test_jax_client_persists_and_async_caches_on_port_worker(port_cluster):
    cluster, pw = port_cluster
    fs = cluster.file_system()
    raw = _payload(7, 3 * BLOCK + 17)
    # THROUGH: the block goes through the port's worker into the UFS
    # (persist_file), then the master frees the cached copy
    fs.write_all("/a/cold", raw, write_type=WriteType.THROUGH)
    info = fs.get_status("/a/cold")
    assert info.persisted and info.ufs_path
    with open(info.ufs_path, "rb") as f:
        assert f.read() == raw
    bm = cluster.block_client()
    deadline = time.monotonic() + 30
    while any(bm.get_block_info(b).locations for b in info.block_ids):
        assert time.monotonic() < deadline, "the cached copy was not freed"
        pw.worker.heartbeat()  # carries the master's FREE command
    assert not pw.worker.store.block_report()["MEM"]
    # an async cache of the persisted blocks lands on the port's worker
    client = JaxWorkerClient(f"localhost:{pw.port}")
    for fbi in fs.fs_master.get_file_block_info_list("/a/cold"):
        b = fbi.block_info
        assert client.async_cache(b.block_id, info.ufs_path, fbi.offset,
                                  b.length, info.mount_id)
    assert pw.worker.async_cache.wait_idle(30)
    pw.worker.heartbeat()  # reports the cached blocks
    for bid in info.block_ids:
        assert [l.address.rpc_port
                for l in bm.get_block_info(bid).locations] == [pw.port]
    assert fs.read_all("/a/cold") == raw


# -- (b) the port's client against a JAX worker ------------------------------
def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the class is the observation
        return ("error", type(e).__name__)


def test_port_client_matches_jax_client(tmp_path):
    with LocalCluster(str(tmp_path), num_workers=1, block_size=BLOCK,
                      conf_overrides=SHM_OFF) as cluster:
        fs = cluster.file_system()
        fs.write_all("/b/cold", _payload(3, 2 * BLOCK),
                     write_type=WriteType.THROUGH)
        info = fs.get_status("/b/cold")
        fbis = fs.fs_master.get_file_block_info_list("/b/cold")
        address = cluster.workers[0].address
        jw = cluster.workers[0].worker
        while any(jw.store.has_block(b) for b in info.block_ids):
            jw._master_sync.heartbeat()  # carries the master's FREE
        clients = {"jax": JaxWorkerClient(address),
                   "port": WorkerClient(address)}
        session = ids.create_session_id()

        def script(c, base):
            """The same calls through one client; state-changing calls
            use block ids of their own per client."""
            a, b = ids.block_id(base, 0), ids.block_id(base + 1, 0)
            raw = _payload(base, BLOCK + 5)
            out = {"write": _outcome(lambda: c.write_block(a, session, raw,
                                                           chunk_size=4096)),
                   "rewrite": _outcome(lambda: c.write_block(
                       a, session, raw)),
                   "read": _outcome(lambda: c.read_block_bytes(
                       a, chunk_size=8192) == raw),
                   "read_range": _outcome(lambda: c.read_block_bytes(
                       a, offset=100, length=300) == raw[100:400]),
                   "read_absent": _outcome(lambda: c.read_block_bytes(
                       b + 99)),
                   "open_local": _outcome(lambda: c.open_local_block(
                       session, a)["length"]),
                   "close_local": _outcome(lambda: c.close_local_block(
                       session, a)),
                   "open_absent": _outcome(lambda: c.open_local_block(
                       session, b + 99)),
                   "create_local": _outcome(lambda: os.path.basename(
                       c.create_local_block(session, b, size_hint=10))
                       == f"{session}_{b}"),
                   "complete_unknown": _outcome(
                       lambda: c.complete_local_block(session, b + 98)),
                   "abort_local": _outcome(lambda: c.complete_local_block(
                       session, b, cancel=True)),
                   "pin": _outcome(lambda: c.prefetch_pin(a)),
                   "pin_absent": _outcome(lambda: c.prefetch_pin(b + 99)),
                   "unpin": _outcome(lambda: c.prefetch_unpin(a)),
                   "move_bad_tier": _outcome(lambda: c.move_block(a, "NOPE")),
                   "remove": _outcome(lambda: c.remove_block(a)),
                   "remove_absent": _outcome(lambda: c.remove_block(a))}
            return out

        want = script(clients["jax"], 1000)
        got = script(clients["port"], 2000)
        assert got == want
        # the port's cancellable stream against the JAX worker: cancel
        # after the first chunk ends iteration quietly
        raw = _payload(2000, BLOCK + 5)
        bid = ids.block_id(2002, 0)
        clients["port"].write_block(bid, session, raw)
        stream = clients["port"].read_block_stream(bid, chunk_size=4096)
        chunks = []
        for msg in stream:
            chunks.append(msg["data"])
            stream.cancel()
        assert stream.cancelled and chunks == [raw[:4096]]
        assert want["open_absent"] == ("error", "BlockDoesNotExistError")
        assert want["rewrite"] == ("error", "AlreadyExistsError")
        # async caches of the persisted file's cold blocks: one through
        # each client, both accepted, both land
        accepted = []
        for name, fbi in zip(("jax", "port"), fbis):
            bi = fbi.block_info
            accepted.append(clients[name].async_cache(
                bi.block_id, info.ufs_path, fbi.offset, bi.length,
                info.mount_id, qos_class="PREFETCH"))
        assert accepted == [True, True]
        assert jw.async_cache.wait_idle(30)
        for fbi in fbis:
            assert jw.store.has_block(fbi.block_info.block_id)


# -- (c) the loader over the port's worker -----------------------------------
def test_loader_over_port_worker_matches_jax(port_cluster):
    cluster, pw = port_cluster
    fs = cluster.file_system()
    paths = []
    for i in range(3):
        raw = np.random.default_rng(40 + i).integers(
            -2**31, 2**31 - 1, size=2 * BLOCK // 4, dtype=np.int32).tobytes()
        fs.write_all(f"/c/shard-{i}", raw, write_type=WriteType.MUST_CACHE)
        paths.append(f"/c/shard-{i}")
    jl = JaxDeviceBlockLoader(fs, paths, hbm_bytes=8 * BLOCK,
                              dtype=np.int32)
    tl = DeviceBlockLoader(fs, paths, device="cpu", hbm_bytes=8 * BLOCK,
                           prefetch=2, dtype=np.int32)
    try:
        jblocks = list(jl.epoch())
        tblocks = list(tl.epoch())
        assert len(tblocks) == 6
        for j, t in zip(jblocks, tblocks):
            assert np.array_equal(np.asarray(j), t.numpy())
        x = jax_rk.pad_to_kernel_shape(
            jnp.concatenate(jblocks).reshape(-1), rows=512)
        want = int(jax_rk.scaled_sum(x, jnp.int32(3), rows=512,
                                     interpret=True))
        got = int(rk.scaled_sum(rk.pad_to_kernel_shape(
            torch.cat(tblocks), rows=512), 3, rows=512))
        assert got == want
    finally:
        jl.close()
        tl.close()
    assert pw.worker.store.active_locks() == 0
