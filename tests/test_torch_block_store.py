"""The port's block-routing ladder and location policies against the JAX
package's, on the CPU.

- Every policy of ``client/policy.py`` (and ``BlockLocationPolicy.create``)
  picks the JAX policy's worker over seeded worker lists, their random
  choices seeded alike.
- ``BlockStoreClient.open_block``: each rung of the ladder — SHM, lease,
  remote, UFS — and the falls between them from real causes (a full
  lease table, a block below the top tier, a segment file gone before
  the map) opens the same kind of stream, from the same source, with the
  same bytes as the JAX ``BlockStoreClient`` on a JAX ``LocalCluster``
  whose one worker is the port's; and ``close()`` leaves no lease.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu.client import policy as jax_policy  # noqa: E402
from alluxio_tpu.client.block_store import \
    BlockStoreClient as JaxBlockStoreClient  # noqa: E402
from alluxio_tpu.client.remote_read import \
    RemoteReadConf as JaxRemoteReadConf  # noqa: E402
from alluxio_tpu.utils import wire as jax_wire  # noqa: E402
from alluxio_tpu_torch.client import policy  # noqa: E402
from alluxio_tpu_torch.client.block_store import BlockStoreClient  # noqa: E402
from alluxio_tpu_torch.client.remote_read import RemoteReadConf  # noqa: E402
from alluxio_tpu_torch.utils import wire  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

KB = 1024
BLOCK = 64 * KB


# -- policies -------------------------------------------------------------------
def _workers(rng, n):
    """Seeded wire dicts of ``n`` workers: hosts, slices, capacities."""
    out = []
    for i in range(n):
        host = f"h{int(rng.integers(3))}"
        ident = [{"tier": "host", "value": host},
                 {"tier": "slice", "value": f"s{int(rng.integers(2))}"}]
        cap = int(rng.integers(1, 100)) * KB
        out.append(jax_wire.WorkerInfo(
            id=i, address=jax_wire.WorkerNetAddress(
                host=host, rpc_port=1000 + i,
                tiered_identity=jax_wire.TieredIdentity.from_wire(
                    {"tiers": ident})),
            capacity_bytes=cap,
            used_bytes=int(rng.integers(0, cap))).to_wire())
    return out


@pytest.mark.parametrize("kind,kwargs", [
    ("LOCAL_FIRST", {}), ("LOCAL_FIRST_AVOID_EVICTION", {}),
    ("MOST_AVAILABLE", {}), ("ROUND_ROBIN", {}),
    ("DETERMINISTIC_HASH", {"shards": 2}),
    ("SPECIFIC_HOST", {"hostname": "h1"})])
def test_policy_picks_match_jax(kind, kwargs):
    rng = np.random.default_rng(41)
    spec = "host=h0,slice=s1"
    port = policy.BlockLocationPolicy.create(
        kind, identity=wire.TieredIdentity.from_spec(spec), **kwargs)
    jax = jax_policy.BlockLocationPolicy.create(
        kind, identity=jax_wire.TieredIdentity.from_spec(spec), **kwargs)
    for p in (port, jax):
        inner = getattr(p, "_inner", p)
        if hasattr(inner, "_rng"):
            inner._rng.seed(42)
    for trial in range(60):
        ws = _workers(rng, int(rng.integers(0, 6)))
        bid = int(rng.integers(1 << 40))
        size = int(rng.integers(0, 80)) * KB
        got = port.pick([wire.WorkerInfo.from_wire(w) for w in ws],
                        block_id=bid, block_size=size)
        want = jax.pick([jax_wire.WorkerInfo.from_wire(w) for w in ws],
                        block_id=bid, block_size=size)
        assert (got and got.to_wire()) == (want and want.to_wire()), trial
    with pytest.raises(ValueError):
        policy.BlockLocationPolicy.create("NO_SUCH")


# -- the ladder -------------------------------------------------------------------
@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """A JAX cluster whose one worker is the port's, with cached and
    persisted-only files."""
    from alluxio_tpu.minicluster import LocalCluster

    from tests.testutils.torch_worker import PortWorker

    base = tmp_path_factory.mktemp("ladder")
    with LocalCluster(str(base), num_workers=0, block_size=BLOCK) as c:
        pw = PortWorker(c, str(base))
        fs = c.file_system()
        data = {}
        for i, wt in enumerate(["MUST_CACHE"] * 5 + ["THROUGH"]):
            d = np.random.default_rng(50 + i).integers(
                0, 256, BLOCK, dtype=np.uint8).tobytes()
            fs.write_all(f"/l{i}", d, write_type=wt)
            data[f"/l{i}"] = d
        fs.close()
        try:
            yield c, pw, data
        finally:
            pw.stop()


def _fbi_and_ufs(cluster, path):
    """The JAX FileBlockInfo of the file's one block and the UFS
    descriptor the JAX file stream would pass (None unless persisted)."""
    fsm = cluster.fs_client()
    info = fsm.get_status(path)
    fbi = fsm.get_file_block_info_list(path)[0]
    ufs = None
    if info.persisted and info.ufs_path:
        ufs = {"ufs_path": info.ufs_path, "offset": 0,
               "length": fbi.block_info.length, "mount_id": info.mount_id}
    return fbi, ufs


def _rung_of_jax(stream) -> str:
    name = type(stream).__name__
    if name == "ShmBlockInStream":
        return "shm"
    if name == "LocalBlockInStream":
        return "lease"
    return "remote" if stream._replicas else "ufs"


def _open(side, cluster, fbi, ufs, **kw):
    """Open the block through one package's BlockStoreClient; returns
    (rung, stream class, bytes, serving source)."""
    if side == "jax":
        store = JaxBlockStoreClient(
            cluster.block_client(), passive_cache=False,
            remote_read=JaxRemoteReadConf(stripe_size=16 * KB,
                                          hedge_quantile=0.0), **kw)
    else:
        store = BlockStoreClient(
            cluster.block_client(), passive_cache=False,
            remote_read=RemoteReadConf(stripe_size=16 * KB,
                                       hedge_quantile=0.0), **kw)
        fbi = wire.FileBlockInfo.from_wire(fbi.to_wire())
    try:
        stream = store.open_block(fbi, ufs_info=ufs, cache_cold_reads=False)
        rung = stream.rung if side == "port" else _rung_of_jax(stream)
        out = (rung, type(stream).__name__, stream.pread(0, BLOCK),
               stream.last_source)
        stream.close()
        return out
    finally:
        store.close()


CASES = {
    "shm": ("/l0", {}),
    "lease": ("/l1", {"shm_enabled": False}),
    "remote": ("/l2", {"short_circuit": False}),
    "ufs": ("/l5", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_each_rung_matches_jax(cluster, case):
    c, pw, data = cluster
    path, kw = CASES[case]
    fbi, ufs = _fbi_and_ufs(c, path)
    if case == "ufs":
        # cold: no worker holds the persisted block
        bid = fbi.block_info.block_id
        if pw.worker.store.has_block(bid):
            pw.worker.store.remove_block(bid)
        fbi.block_info.locations = []
    got = {side: _open(side, c, fbi, ufs, **kw) for side in ("jax", "port")}
    assert got["port"] == got["jax"]
    rung, _, payload, _ = got["port"]
    assert rung == case and payload == data[path]
    assert pw.worker.shm_store.stats()["live_leases"] == 0


def test_full_lease_table_falls_to_lease(cluster):
    c, pw, data = cluster
    fbi, ufs = _fbi_and_ufs(c, "/l3")
    shm = pw.worker.shm_store
    shm.max_leases = 0  # every grant is denied
    try:
        got = {side: _open(side, c, fbi, ufs) for side in ("jax", "port")}
    finally:
        shm.max_leases = 1024
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ("lease", "LocalBlockInStream", data["/l3"])


def test_block_below_top_tier_falls_to_lease(cluster):
    c, pw, data = cluster
    pw.worker.store.move_block(
        c.fs_client().get_status("/l4").block_ids[0], "SSD")
    fbi, ufs = _fbi_and_ufs(c, "/l4")
    got = {side: _open(side, c, fbi, ufs) for side in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ("lease", "LocalBlockInStream", data["/l4"])


def test_missing_segment_file_falls_to_remote(cluster):
    """The MEM-tier file is gone when the client maps it: the SHM rung
    gives its lease back, the lease rung cannot open the file either,
    and the remote rung opens the stream (lazy); with the file back the
    stream reads the block's bytes."""
    c, pw, data = cluster
    bid = c.fs_client().get_status("/l0").block_ids[0]
    path = pw.worker.store.get_block_meta(bid).path
    fbi, ufs = _fbi_and_ufs(c, "/l0")
    got = {}
    for side in ("jax", "port"):
        os.rename(path, path + ".away")
        try:
            if side == "jax":
                store = JaxBlockStoreClient(c.block_client(),
                                            passive_cache=False)
                f = fbi
            else:
                store = BlockStoreClient(c.block_client(),
                                         passive_cache=False)
                f = wire.FileBlockInfo.from_wire(fbi.to_wire())
            stream = store.open_block(f, ufs_info=ufs)
            leases = pw.worker.shm_store.stats()["live_leases"]
        finally:
            os.rename(path + ".away", path)
        try:
            got[side] = (stream.rung if side == "port"
                         else _rung_of_jax(stream), type(stream).__name__,
                         leases, stream.pread(0, BLOCK) == data["/l0"])
        finally:
            store.close()
    assert got["port"] == got["jax"] == \
        ("remote", "GrpcBlockInStream", 0, True)


def test_close_releases_every_lease(cluster):
    """A client that read through the SHM rung holds a lease and an SHM
    pin a block; ``close()`` releases them all on the worker."""
    c, pw, data = cluster
    store = BlockStoreClient(c.block_client(), passive_cache=False)
    paths = ["/l0", "/l1", "/l2"]
    for p in paths:
        fbi, ufs = _fbi_and_ufs(c, p)
        stream = store.open_block(wire.FileBlockInfo.from_wire(
            fbi.to_wire()), ufs_info=ufs)
        assert stream.rung == "shm"
        assert stream.numpy_view().tobytes() == data[p]
    shm = pw.worker.shm_store
    assert shm.stats()["live_leases"] == len(paths)
    assert len(pw.worker.store.shm_leased_blocks) == len(paths)
    store.close()
    assert shm.stats()["live_leases"] == 0
    assert not pw.worker.store.shm_leased_blocks


def test_from_conf_reads_the_keys(cluster):
    from alluxio_tpu_torch.conf import Configuration, Keys

    c, _, _ = cluster
    conf = Configuration(load_env=False)
    conf.set(Keys.USER_SHM_ENABLED, False)
    conf.set(Keys.USER_REMOTE_READ_STRIPE_SIZE, 0)
    conf.set(Keys.USER_BATCH_READ_MAX_OPS, 8)
    store = BlockStoreClient.from_conf(c.block_client(), conf,
                                       short_circuit=False)
    try:
        assert store.shm is None and not store.remote_read.enabled
        assert store.batch_read.max_ops == 8
    finally:
        store.close()


def test_striped_cold_read_is_one_ufs_read(cluster):
    """The UFS rung stripes a cold block (four 16 KiB stripes, all in
    flight at once) and caches it: the port's worker reads the UFS once
    and caches the block once, and the bytes are the file's."""
    from alluxio_tpu_torch.metrics import metrics

    c, pw, data = cluster
    fbi, ufs = _fbi_and_ufs(c, "/l5")
    bid = fbi.block_info.block_id
    if pw.worker.store.has_block(bid):
        pw.worker.store.remove_block(bid)
    fbi.block_info.locations = []
    m = metrics()
    r0 = m.counter("Worker.UfsBlocksRead").count
    s0 = m.counter("Client.RemoteReadStripes").count
    store = BlockStoreClient(
        c.block_client(), passive_cache=False,
        remote_read=RemoteReadConf(stripe_size=16 * KB, hedge_quantile=0.0))
    try:
        stream = store.open_block(wire.FileBlockInfo.from_wire(
            fbi.to_wire()), ufs_info=ufs)
        got = stream.pread(0, BLOCK)
        stream.close()
    finally:
        store.close()
    assert stream.rung == "ufs" and got == data["/l5"]
    assert m.counter("Client.RemoteReadStripes").count - s0 == 4
    assert m.counter("Worker.UfsBlocksRead").count - r0 == 1
    assert pw.worker.store.has_block(bid)
