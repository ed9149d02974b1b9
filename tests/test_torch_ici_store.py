"""The port's ``MeshBlockCache`` against the JAX package's, byte for
byte (tolerance 0: these are byte moves).

One module-scoped fixture spawns a gloo group of 2 ranks and one of 4
(``tests/testutils/torch_dist.py``); every rank loads its shard of the
same seeded dataset (ragged: a short last file and a padded tail) from
an in-memory namespace and runs every method. The JAX cache runs the
same calls on a 2- and a 4-device mesh of the fake CPU devices, and
each test compares one method. A world-1 test runs in this process
against a ``LocalCluster``, checking that the placement report lands in
the master's device block map. The workers import only torch, numpy and
the port.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader  # noqa: E402
from alluxio_tpu_torch.parallel.ici_store import MeshBlockCache  # noqa: E402
from alluxio_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from tests.testutils.torch_dist import cpu_group, run_groups  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

BLOCK = 1024
WORLDS = (2, 4)
HOST = "meshclient0"


def shifts_of(world):
    """Ring shifts to check; none is a multiple of ``world``, since gloo
    cannot pair a rank with itself."""
    return (1, world - 1, world + 1)


def batch_of(world):
    """Global indices: repeats, and the padded last row."""
    return (3, 0, 2 * world - 1, 3, 1)


def dataset(world: int):
    """path -> bytes: 2*world - 1 blocks in all, the last file short, so
    the last rank holds a padded row and a short (zero-filled) one."""
    rng = np.random.default_rng(100 + world)
    files = {}
    n_blocks = 2 * world - 1
    for i in range(n_blocks - 2):
        files[f"/ici/b{i}"] = rng.integers(0, 256, BLOCK, np.uint8)
    # one file of two blocks, the second short
    files["/ici/two"] = rng.integers(0, 256, BLOCK + BLOCK // 3, np.uint8)
    fresh = {f"/fresh/f{i}": rng.integers(0, 256, BLOCK, np.uint8)
             for i in range(2)}
    return files, fresh


def rows_of(files, n_devices):
    """The global (padded) rows the warm set holds."""
    rows = []
    for data in files.values():
        for start in range(0, len(data), BLOCK):
            row = np.zeros(BLOCK, np.uint8)
            part = data[start:start + BLOCK]
            row[:len(part)] = part
            rows.append(row)
    per_dev = -(-len(rows) // n_devices)
    rows += [np.zeros(BLOCK, np.uint8)] * (per_dev * n_devices - len(rows))
    return np.stack(rows)


class Recorder:
    """A block-master client that records the placement calls."""

    def __init__(self):
        self.calls = []

    def report_device_blocks(self, host, mesh_blocks):
        self.calls.append(("report", host, {int(k): list(v) for k, v in
                                            mesh_blocks.items()}))

    def clear_device_blocks(self, host):
        self.calls.append(("clear", host))


class MemFS:
    """The calls the loaders make, over in-memory files of BLOCK-sized
    blocks; ``store.block_master`` records placement reports."""

    def __init__(self, files):
        self.files = dict(files)
        self.store = SimpleNamespace(block_master=Recorder())
        self._ids = {p: i + 1 for i, p in enumerate(sorted(self.files))}

    def add(self, files):
        self.files.update(files)
        self._ids = {p: i + 1 for i, p in enumerate(sorted(self.files))}

    def get_status(self, path):
        n = -(-len(self.files[path]) // BLOCK)
        fid = self._ids[path]
        return SimpleNamespace(file_id=fid,
                               block_ids=[fid * 100 + i for i in range(n)])

    def open_file(self, path, info=None, max_open_streams=1):
        data = self.files[path]
        return SimpleNamespace(
            block_stream=lambda i: SimpleNamespace(
                read_all=lambda: data[i * BLOCK:(i + 1) * BLOCK].tobytes(),
                source_bucket=lambda: "shm"),
            close=lambda: None)


def scenario(rank, world, out_dir):
    """Every method of the port's cache on this rank's shard."""
    files, fresh = dataset(world)
    fs = MemFS(files)
    mesh = make_mesh({"data": world}, device_type="cpu")
    cache = MeshBlockCache(mesh, block_bytes=BLOCK, client_host=HOST)
    paths = list(files)
    loader = DeviceBlockLoader(fs, paths, device="cpu", hbm_bytes=0)
    try:
        cached = cache.load_global(fs, paths, loader=loader)
    finally:
        loader.close()
    out = {"shard": cached.numpy().copy(),
           "placement": cache.placement(len(cache.plan)),
           "describe": cache.describe_placement(cached),
           "gather_all": cache.gather_all(cached).numpy(),
           "ring_shift": {s: cache.ring_shift(cached, shift=s).numpy()
                          for s in shifts_of(world)},
           "global_batch": cache.global_batch(
               cached, torch.tensor(batch_of(world))).numpy(),
           "replicate": {b: cache.replicate(cached, b).numpy()
                         for b in (0, 3, 2 * world - 2)},
           "block_ids": list(cache.block_ids)}
    with pytest.raises(IndexError):
        cache.replicate(cached, cached.shape[0] * world)
    before_plan, before = list(cache.plan), cached.clone()
    with pytest.raises(IndexError):  # validated before any mutation
        cache.turnover(cached, fs, {0: ("/fresh/f0", 0),
                                    len(cache.plan): ("/fresh/f1", 0)})
    out["bad_turnover_kept"] = (cache.plan == before_plan
                                and torch.equal(cached, before))
    fs.add(fresh)
    new_loader = DeviceBlockLoader(fs, list(fresh), device="cpu",
                                   hbm_bytes=0)
    try:
        after = cache.turnover(cached, fs, turnover_map(world),
                               loader=new_loader)
    finally:
        new_loader.close()
    out["turnover_in_place"] = after is cached
    out["turnover"] = after.numpy()
    out["plan"] = list(cache.plan)
    cache.drop_placement(fs)
    out["calls"] = fs.store.block_master.calls
    return out


def turnover_map(world):
    return {0: ("/fresh/f0", 0), 2 * world - 2: ("/fresh/f1", 0)}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    groups = {f"w{n}": (n, "scenario") for n in WORLDS}
    return run_groups(__name__, groups,
                      tmp_path_factory.mktemp("ici_store"))


@functools.lru_cache(maxsize=None)
def jax_side(world):
    """The JAX package's cache on a ``world``-device mesh, the same
    calls (loaders with prefetch 0: the in-memory namespace has no
    conf)."""
    import jax

    from alluxio_tpu.client.jax_io import DeviceBlockLoader as JaxLoader
    from alluxio_tpu.parallel.ici_store import MeshBlockCache as JaxCache
    from alluxio_tpu.parallel.mesh import make_mesh as jax_mesh

    files, fresh = dataset(world)
    fs = MemFS(files)
    mesh = jax_mesh({"data": world}, devices=jax.devices()[:world])
    cache = JaxCache(mesh, block_bytes=BLOCK, client_host=HOST)
    loader = JaxLoader(fs, list(files), hbm_bytes=0, prefetch=0)
    try:
        cached = cache.load_global(fs, list(files), loader=loader)
    finally:
        loader.close()
    out = {"global": np.asarray(cached),
           "placement": cache.placement(len(cache.plan)),
           "describe": cache.describe_placement(cached),
           "gather_all": np.asarray(cache.gather_all(cached)),
           "ring_shift": {s: np.asarray(cache.ring_shift(cached, shift=s))
                          for s in shifts_of(world)},
           "global_batch": np.asarray(cache.global_batch(
               cached, list(batch_of(world)))),
           "replicate": {b: np.asarray(cache.replicate(cached, b))
                         for b in (0, 3, 2 * world - 2)},
           "block_ids": list(cache.block_ids)}
    fs.add(fresh)
    new_loader = JaxLoader(fs, list(fresh), hbm_bytes=0, prefetch=0)
    try:
        out["turnover"] = np.asarray(cache.turnover(
            cached, fs, turnover_map(world), loader=new_loader))
    finally:
        new_loader.close()
    out["plan"] = list(cache.plan)
    cache.drop_placement(fs)
    out["calls"] = fs.store.block_master.calls
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_load_global_shards_by_mesh_position(port, world):
    ranks, want = port[f"w{world}"], jax_side(world)
    files, _ = dataset(world)
    np.testing.assert_array_equal(
        np.concatenate([r["shard"] for r in ranks]), want["global"])
    np.testing.assert_array_equal(want["global"], rows_of(files, world))
    assert all(r["placement"] == want["placement"] for r in ranks)
    merged = {}
    for r in ranks:
        merged.update(r["describe"])
    assert merged == want["describe"]
    assert all(r["block_ids"] == want["block_ids"] for r in ranks)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_all(port, world):
    for r in port[f"w{world}"]:
        np.testing.assert_array_equal(r["gather_all"],
                                      jax_side(world)["gather_all"])


@pytest.mark.parametrize("world", WORLDS)
def test_ring_shift(port, world):
    want = jax_side(world)["ring_shift"]
    for shift, arr in want.items():
        got = np.concatenate([r["ring_shift"][shift]
                              for r in port[f"w{world}"]])
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("world", WORLDS)
def test_global_batch(port, world):
    want = jax_side(world)["global_batch"]
    assert want.shape == (len(batch_of(world)), BLOCK)
    for r in port[f"w{world}"]:
        np.testing.assert_array_equal(r["global_batch"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_replicate(port, world):
    for r in port[f"w{world}"]:
        for b, arr in jax_side(world)["replicate"].items():
            np.testing.assert_array_equal(r["replicate"][b], arr)


@pytest.mark.parametrize("world", WORLDS)
def test_turnover_replaces_rows_in_place(port, world):
    ranks, want = port[f"w{world}"], jax_side(world)
    assert all(r["bad_turnover_kept"] for r in ranks)
    assert all(r["turnover_in_place"] for r in ranks)
    np.testing.assert_array_equal(
        np.concatenate([r["turnover"] for r in ranks]), want["turnover"])
    assert all(r["plan"] == want["plan"] for r in ranks)


@pytest.mark.parametrize("world", WORLDS)
def test_placement_reports(port, world):
    """Load and turnover each report this host's placement once (the
    ranks' maps merged), as the JAX cache does; drop clears it."""
    ranks, want = port[f"w{world}"], jax_side(world)
    reports = [c for r in ranks for c in r["calls"] if c[0] == "report"]
    assert reports == [c for c in want["calls"] if c[0] == "report"]
    assert len(reports) == 2
    assert all(("clear", HOST) in r["calls"] for r in ranks)


def test_world_one_reports_to_the_cluster_master(tmp_path):
    """A gloo group of one in this process, the JAX cluster's client as
    the namespace: the port's cache loads through its own loader and
    the report lands in the master's device block map."""
    import torch.distributed as dist

    from alluxio_tpu.client.streams import WriteType
    from alluxio_tpu.minicluster import LocalCluster

    block = 4096
    with LocalCluster(str(tmp_path / "cluster"), num_workers=1,
                      block_size=block,
                      worker_mem_bytes=16 << 20) as cluster:
        fs = cluster.file_system()
        rng = np.random.default_rng(7)
        payloads = [rng.integers(0, 256, block, np.uint8) for _ in range(3)]
        for i, p in enumerate(payloads):
            fs.write_all(f"/ici/b{i}", p.tobytes(),
                         write_type=WriteType.MUST_CACHE)
        cpu_group(tmp_path / "store")
        try:
            mesh = make_mesh({"data": 1}, device_type="cpu")
            cache = MeshBlockCache(mesh, block_bytes=block,
                                   client_host="torchclient0")
            cached = cache.load_global(fs, [f"/ici/b{i}" for i in range(3)])
            np.testing.assert_array_equal(cached.numpy(), np.stack(payloads))
            bc = cluster.block_client()
            dev_map = bc.device_block_map()
            assert sorted(dev_map) == sorted(cache.block_ids)
            assert all(posmap == {0: "torchclient0"}
                       for posmap in dev_map.values())
            batch = cache.global_batch(cached, [2, 0])
            np.testing.assert_array_equal(batch.numpy(),
                                          np.stack([payloads[2],
                                                    payloads[0]]))
            cache.drop_placement(fs)
            assert bc.device_block_map() == {}
        finally:
            dist.destroy_process_group()
            fs.close()


@pytest.mark.parametrize("row_bytes,word", [(16, torch.int64),
                                            (12, torch.int32),
                                            (6, torch.int16),
                                            (3, torch.uint8)])
def test_batch_rows_move_as_the_widest_words(row_bytes, word):
    """``global_batch`` sums integer words (owner's bits plus zeros), so
    any dtype's bits survive: float32 -0.0 and a NaN payload too."""
    from alluxio_tpu_torch.parallel.ici_store import _as_words

    raw = np.random.default_rng(row_bytes).integers(
        0, 256, (3, row_bytes), np.uint8)
    words = _as_words(torch.from_numpy(raw))
    assert words.dtype == word
    np.testing.assert_array_equal(words.view(torch.uint8).numpy(), raw)
    f = torch.tensor([[-0.0, float("nan")]], dtype=torch.float32)
    back = (_as_words(f) + 0).view(torch.float32)
    assert torch.equal(back.view(torch.int32), f.view(torch.int32))
