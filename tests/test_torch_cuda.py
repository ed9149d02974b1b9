"""Tests of the port that need a CUDA card (marker ``cuda``; they skip
without one). On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Kernel results are compared with the plain PyTorch version exactly
(tolerance 0: both wrap in int32). This module imports no JAX, so it
runs where only PyTorch is installed.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alluxio_tpu_torch.ops import reduce_kernel as rk  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

_BLOCK = rk._ROWS * rk._LANES

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _random_int32(n, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=n,
                                         dtype=np.int32)).to(device)


@pytest.mark.parametrize("rows", rk.CALIBRATION_ROWS)
def test_kernel_matches_reference(cuda, rows):
    x = _random_int32(3 * rows * rk._LANES, rows, cuda)
    for scale in (1, 3, -2):
        s = torch.tensor([scale], dtype=torch.int32, device=cuda)
        before = rk.launches
        got = rk.scaled_sum(x, s, rows=rows)
        assert rk.launches == before + 1
        assert got.device == cuda and got.dtype == torch.int32
        assert int(got) == int(rk.scaled_sum_reference(x, s))


def test_kernel_matches_host_over_random_inputs(cuda):
    """Many seeded (size, scale) cases, each held against both the plain
    version on the card and numpy's sum of a host copy, so that a wrong
    answer shows whether the kernel or the input read was at fault."""
    rng = np.random.default_rng(20261016)
    for case in range(1000):
        rows = int(rng.choice([512, 1024, 2048, 3584, 4096]))
        scale = int(rng.choice([1, 3, -2, 12345]))
        x = _random_int32(rows * rk._LANES, case, cuda)
        got = int(rk.scaled_sum(x, scale))
        plain = int(rk.scaled_sum_reference(x, scale))
        total = int((x.cpu().numpy().astype(np.int64) * scale).sum())
        host = (total + (1 << 31)) % (1 << 32) - (1 << 31)
        assert (got, plain) == (host, host), (case, rows, scale)


def test_unaligned_view_takes_the_scalar_path(cuda):
    base = _random_int32(2 * _BLOCK + 1, 11, cuda)
    x = base[1:]  # 4 bytes past a 16-byte boundary
    assert x.data_ptr() % 16 != 0
    assert int(rk.scaled_sum(x, 7)) == int(rk.scaled_sum_reference(x, 7))


def test_wraparound(cuda):
    x = torch.full((_BLOCK,), 2**30, dtype=torch.int32, device=cuda)
    assert int(rk.scaled_sum(x, 3)) == int(rk.scaled_sum_reference(x, 3))


def test_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.ones(2 * _BLOCK, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        rk.scaled_sum(x.view(2, _BLOCK).t(), 1)  # not contiguous
    with pytest.raises(ValueError):
        rk.scaled_sum(x, torch.ones(1, dtype=torch.int32))  # scale on cpu


def test_loader_chain_on_card(cuda, tmp_path):
    """Block files -> the port's loader on the card -> device tier ->
    chained scans, against the plain version."""
    from types import SimpleNamespace

    from alluxio_tpu_torch.client.block_streams import LocalBlockInStream
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.metrics import metrics

    files = {}
    for i in range(3):
        path = tmp_path / f"b{i}"
        _random_int32(_BLOCK, 100 + i, "cpu").numpy().tofile(path)
        files[f"/f{i}"] = str(path)

    class Source:
        def get_status(self, p):
            fid = int(p[2:]) + 1
            return SimpleNamespace(file_id=fid, block_ids=[fid])

        def open_file(self, p, info=None, max_open_streams=1):
            stream = LocalBlockInStream.from_path(files[p],
                                                  os.path.getsize(files[p]))
            return SimpleNamespace(block_stream=lambda i: stream,
                                   close=stream.close)

    loader = DeviceBlockLoader(Source(), list(files), hbm_bytes=16 << 20,
                               dtype=np.int32)
    try:
        assert loader.device.type == "cuda"
        list(loader.epoch())
        hits0 = metrics().counter("Client.JaxHbmHits").count
        blocks = list(loader.epoch())
        assert metrics().counter("Client.JaxHbmHits").count - hits0 == 3
        x = torch.cat(blocks)
        acc = ref = torch.zeros((), dtype=torch.int32, device=cuda)
        for _ in range(3):
            acc = torch.remainder(
                rk.scaled_sum(x, torch.remainder(acc, 3) + 1) + acc,
                1000003)
            ref = torch.remainder(
                rk.scaled_sum_reference(x, torch.remainder(ref, 3) + 1)
                + ref, 1000003)
        assert int(acc) == int(ref)
        for i, b in enumerate(blocks):
            want = np.fromfile(files[f"/f{i}"], dtype=np.int32)
            assert np.array_equal(b.cpu().numpy(), want)
    finally:
        loader.close()


def _module(name, relpath):
    """A file of the repository as a module, loaded by its path (so that
    a package named ``tests`` installed elsewhere cannot shadow it)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / relpath
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _smoke():
    """``chip_smoke.py`` as a module (its checks)."""
    return _module("chip_smoke", "chip_smoke.py")


def _prefetching_loader(tmp_path, device, n=4, words=1 << 21):
    """n files of ``words`` int32 on a port ``LocalCluster`` (one worker,
    blocks of a file each), a port PrefetchService placing every block in
    the device tier, and a loader on ``device`` bound to it. Returns the
    host copies (path -> (id, file)), the service, the loader and the
    cluster with its client, for the caller to close."""
    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.minicluster import LocalCluster
    from alluxio_tpu_torch.prefetch import PrefetchService

    cluster = LocalCluster(str(tmp_path / "cluster"), block_size=words * 4,
                           worker_mem_bytes=2 * n * words * 4,
                           start_worker_heartbeats=True).start()
    fs = cluster.file_system()
    files = {}
    for i in range(n):
        path = tmp_path / f"p{i}"
        data = _random_int32(words, 200 + i, "cpu").numpy()
        data.tofile(path)
        fs.write_all(f"/p{i}", data, write_type=WriteType.MUST_CACHE)
        files[f"/p{i}"] = (i + 1, str(path))
    svc = PrefetchService.from_fs(fs, list(files), seed=3,
                                  lookahead_blocks=n,
                                  budget_bytes=n * words * 4,
                                  hbm_fraction=1.0)
    loader = DeviceBlockLoader(fs, list(files), device=device,
                               hbm_bytes=n * words * 4 + (1 << 20),
                               dtype=np.int32, prefetch_service=svc)
    return files, svc, loader, (cluster, fs)


def _close(svc, loader, cluster_fs) -> None:
    cluster, fs = cluster_fs
    try:
        svc.close()
        loader.close()
        fs.close()
    finally:
        cluster.stop()


def test_adopted_pages_read_on_a_side_stream(cuda, tmp_path):
    """Pages adopted by the prefetch agent's thread on the loader's copy
    stream, whose copies are held back by a busy kernel queued there
    first, are read by a consumer on a side stream: every block equals
    its file, since the consumer's stream waits on each copy's event."""
    files, svc, loader, cluster = _prefetching_loader(tmp_path, cuda)
    side = torch.cuda.Stream(device=cuda)
    try:
        with torch.cuda.stream(loader._copy_stream):
            torch.cuda._sleep(200_000_000)  # about 0.1 s of spinning
        assert svc.wait_ready(len(files), timeout_s=60.0, tick=True)
        for pid in [p for (_, _, p) in loader._plan]:
            with loader._hbm.get(pid) as lease:
                assert isinstance(lease.ready, torch.cuda.Event)
        with torch.cuda.stream(side):
            blocks = list(loader.epoch())
            host = [b.cpu() for b in blocks]  # ordered on the side stream
        assert svc.stats()["hits"] == len(files)
        for ref, got in zip(svc.oracle.epoch_sequence(0), host):
            want = np.fromfile(files[ref.path][1], dtype=np.int32)
            assert np.array_equal(got.numpy(), want), ref.path
    finally:
        _close(svc, loader, cluster)


def test_get_device_on_the_card(cuda):
    """``LocalCacheManager.get_device`` on a CUDA store: a promotion
    gives a CUDA tensor with the page's bytes, and the second call is a
    device hit."""
    from alluxio_tpu_torch.client.cache.hbm_store import HbmPageStore
    from alluxio_tpu_torch.client.cache.manager import LocalCacheManager
    from alluxio_tpu_torch.client.cache.meta import PageId
    from alluxio_tpu_torch.client.cache.page_store import MemPageStore
    from alluxio_tpu_torch.metrics import metrics

    page = np.random.default_rng(2).integers(0, 256, 1 << 20,
                                             dtype=np.uint8)
    cache = LocalCacheManager(MemPageStore(), capacity_bytes=4 << 20,
                              hbm_store=HbmPageStore(4 << 20))
    hits = metrics().counter("Client.HbmPageHits")
    promotions = metrics().counter("Client.HbmPagePromotions")
    try:
        h0, p0 = hits.count, promotions.count
        with cache.get_device(PageId("f", 0),
                              host_fallback=lambda: page) as lease:
            assert lease.array.device.type == "cuda"
            assert np.array_equal(lease.array.cpu().numpy(), page)
        assert (hits.count - h0, promotions.count - p0) == (0, 1)
        with cache.get_device(PageId("f", 0)) as lease:
            assert lease.array.device.type == "cuda"
        assert (hits.count - h0, promotions.count - p0) == (1, 1)
    finally:
        cache.close()


def test_adopt_thread_copies_on_the_loaders_device(cuda, tmp_path):
    """The adopt thread sets no device of its own: its copies run under
    the loader's device on the loader's copy stream. With several cards
    the loader sits on the last one; with one, the copy stream's device
    and every adopted page's are the loader's."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    files, svc, loader, cluster = _prefetching_loader(tmp_path, dev,
                                                      words=1 << 18)
    try:
        assert loader._copy_stream.device == dev
        assert svc.wait_ready(len(files), timeout_s=60.0, tick=True)
        for pid in [p for (_, _, p) in loader._plan]:
            with loader._hbm.get(pid) as lease:
                assert lease.array.device == dev
        blocks = list(loader.epoch())
        assert all(b.device == dev for b in blocks)
        for ref, got in zip(svc.oracle.epoch_sequence(0), blocks):
            want = np.fromfile(files[ref.path][1], dtype=np.int32)
            assert np.array_equal(got.cpu().numpy(), want)
    finally:
        _close(svc, loader, cluster)


def _small_vit(device, seed=0):
    from alluxio_tpu_torch.models.train import make_train_state
    from alluxio_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(vocab_or_patch_dim=48, d_model=32, n_heads=4,
                            d_ff=64, n_layers=2, n_classes=10, max_len=16)
    return cfg, make_train_state(cfg, device=device, seed=seed)


def test_train_steps_on_card_match_cpu(cuda):
    """Three bf16 train steps of a small ViT on the card and on the CPU
    from the same weights. The loss, near ln(10) whatever a forward does
    at initialisation, is held to 1e-3 absolute at each step. The
    parameters after the steps are held as ``test_torch_train.py`` holds
    them against JAX: per tensor, the norm of the difference within
    2**-5 of the tensor's norm, and per element within Adam's step bound
    (2 x lr a step)."""
    from alluxio_tpu_torch.models.train import make_train_step

    cfg, (model, opt, tx) = _small_vit(cuda)
    _, (host, host_opt, _) = _small_vit("cpu")
    assert model.embed.device.type == "cuda"
    step = make_train_step(cfg, tx)
    rng = np.random.default_rng(3)
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((4, 16, 48)).astype(
            np.float32)).to(torch.bfloat16)
        y = torch.from_numpy(rng.integers(0, 10, 4).astype(np.int32))
        model, opt, loss = step(model, opt, x.to(cuda), y.to(cuda))
        host, host_opt, want = step(host, host_opt, x, y)
        assert loss.device.type == "cuda"
        assert abs(float(loss) - float(want)) <= 1e-3
    assert int(opt.count) == 3 and opt.mu[0].device.type == "cuda"
    for got, want in zip(model.leaves(), host.leaves()):
        got, want = got.detach().float().cpu(), want.detach().float()
        diff = got - want
        assert float(diff.norm()) <= 2.0 ** -5 * float(want.norm())
        assert float(diff.abs().max()) <= 2 * tx.learning_rate * 3


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    from alluxio_tpu_torch.models.checkpoint import (load_train_state,
                                                     save_train_state)
    from alluxio_tpu_torch.utils.bf16 import bits
    from alluxio_tpu_torch.utils.pytree import tree_leaves

    class Dir:
        def write_all(self, path, data, **_kw):
            (tmp_path / path.strip("/")).parent.mkdir(parents=True,
                                                      exist_ok=True)
            (tmp_path / path.strip("/")).write_bytes(bytes(data))

        def read_all(self, path):
            return (tmp_path / path.strip("/")).read_bytes()

    _, (model, opt, _) = _small_vit(cuda)
    save_train_state(Dir(), "/c", model.param_tree(), opt, step=1)
    _, (like, like_opt, _) = _small_vit(cuda, seed=5)
    params, got_opt, step = load_train_state(
        Dir(), "/c", like_params=like.param_tree(), like_opt=like_opt)
    assert step == 1
    for a, b in zip(tree_leaves((model.param_tree(), opt)),
                    tree_leaves((params, got_opt))):
        assert b.device == a.device
        assert torch.equal(bits(a), bits(b))


def test_world_one_nccl_mesh_matches_one_card(cuda, tmp_path):
    """Over an NCCL group of one rank on the card, ``chip_smoke.py``'s
    checks (b) and (e) at a small size: 3 dp x tp steps of a small ViT
    bit for bit against the single-card steps, and a one-stage pipeline
    bit for bit against the stage in sequence."""
    import torch.distributed as dist

    from alluxio_tpu_torch.parallel.mesh import make_mesh

    smoke = _smoke()
    cfg, _ = _small_vit("cpu")
    rng = np.random.default_rng(4)
    batches = [(torch.from_numpy(rng.standard_normal((4, 16, 48)).astype(
        np.float32)).to(torch.bfloat16).to(cuda),
        torch.from_numpy(rng.integers(0, 10, 4).astype(np.int32)).to(cuda))
        for _ in range(3)]
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh({"data": 1, "model": 1})
        assert dist.get_backend() == "nccl"
        out = smoke.sharded_step_check(cuda, mesh, cfg, batches, 1e-3)
        assert out["bit_identical"] and out["steps"] == 3
        assert smoke.pipeline_check(cuda, make_mesh({"pipe": 1}),
                                    (4, 32, 64))["bit_identical"]
    finally:
        dist.destroy_process_group()


def test_worker_lease_loader_on_card(cuda, tmp_path):
    _module("torch_worker", "tests/testutils/torch_worker.py") \
        .lease_loader_case(tmp_path, cuda)


def test_worker_shm_loader_on_card(cuda, tmp_path):
    _module("torch_worker", "tests/testutils/torch_worker.py") \
        .shm_loader_case(tmp_path, cuda)


def test_worker_cold_fetch_loader_on_card(cuda, tmp_path):
    """A cold block streamed through the worker's striped fetch into the
    device tier and scanned by the kernel: the scan equals the plain
    scan of the same blocks."""
    _module("torch_worker", "tests/testutils/torch_worker.py") \
        .cold_fetch_loader_case(tmp_path, cuda)


def test_suite_prefetch_onto_the_card(cuda):
    """BASELINE config #3 at 4 files x 8 MiB: the load job's set streamed
    onto the card equals the warm reference set there, and chained scans
    of it by the kernel equal the plain chain over it and over the warm
    reference set."""
    from alluxio_tpu_torch.stress import tpu_suite

    def scan(fn, x):
        acc = torch.zeros((), dtype=torch.int32, device=cuda)
        for _ in range(5):
            acc = torch.remainder(fn(x, torch.remainder(acc, 3) + 1) + acc,
                                  1000003)
        return int(acc)

    def consumer(warm, loaded):
        assert all(t.device == cuda for t in warm + loaded)
        x = torch.cat([t.view(torch.int32) for t in loaded])
        w = torch.cat([t.view(torch.int32) for t in warm])
        before = rk.launches
        got = scan(rk.scaled_sum, x)
        return {"launches": rk.launches - before, "chain": got,
                "equal": bool(torch.equal(x, w)),
                "plain": scan(rk.scaled_sum_reference, x),
                "warm_plain": scan(rk.scaled_sum_reference, w)}

    row = tpu_suite.config3_prefetch(cuda, file_bytes=8 << 20, num_files=4,
                                     consumer=consumer)
    c = row["consumer"]
    assert c["launches"] == 5
    assert c["equal"]
    assert c["chain"] == c["plain"] == c["warm_plain"]
    assert row["num_blocks"] == 8
    assert row["blocks_by_host"] == {"localhost-w0": 4, "localhost-w1": 4}


def test_suite_projection_onto_the_card(cuda, tmp_path):
    """BASELINE config #4 at 2 x 3 000 rows on the port's cluster: the
    three projected columns land on the card, equal to the table's (the
    stage checks them there), and the row carries the reference's keys."""
    from alluxio_tpu_torch.minicluster import LocalCluster
    from alluxio_tpu_torch.stress import tpu_suite

    with LocalCluster(str(tmp_path), block_size=1 << 20) as cluster:
        fs = cluster.file_system()
        row = tpu_suite.config4_projection(fs, cuda, rows_per_part=3000)
        fs.close()
    assert row["columns_checked"] == 6
    assert row["projected_bytes"] == 2 * 3000 * 12
    for key in ("full_scan_s", "projection_s", "full_bytes", "vs_baseline"):
        assert key in row


def test_clairvoyant_bench_on_the_card(cuda):
    """The clairvoyant prefetch bench at 2 files x 4 MiB with device-tier
    placements: every consumed block is on the card and equal to its
    file's bytes, and every block was consumed."""
    from alluxio_tpu_torch.stress import prefetch_bench

    r = prefetch_bench.run_clairvoyant(device=cuda, num_files=2,
                                       file_bytes=4 << 20,
                                       hbm_fraction=0.25)
    m = r.metrics
    assert m["block_mismatches"] == 0
    assert m["blocks_checked"] == 2 * m["blocks_per_epoch"] == 16
    assert m["hits"] + m["late"] + m["misses"] == 16


def test_lost_file_drill_on_the_card(cuda, tmp_path):
    """``chip_smoke.py``'s 2j (a) at 4 x 1 MiB: 2 MUST_CACHE and 2
    CACHE_THROUGH files on a process cluster, an epoch onto the card, the
    worker's process stopped until exactly the MUST_CACHE files are LOST,
    resumed until all are back, and a second epoch whose block sums equal
    the first's (each launch held against the plain version)."""
    smoke = _smoke()
    block = 1 << 20
    files = {}
    for i in range(4):
        path = str(tmp_path / f"shard-{i}.blk")
        np.random.default_rng(i).integers(
            -2**31, 2**31 - 1, size=block // 4, dtype=np.int32).tofile(path)
        files[f"/guards/{'m' if i < 2 else 't'}-{i}"] = path
    names = list(files)
    cluster = smoke.start_guard_cluster(str(tmp_path), block, 16 * block)
    try:
        before = rk.launches
        got = smoke.lost_file_drill(cuda, cluster, files, names[:2],
                                    names[2:])
        assert rk.launches - before == 8
    finally:
        cluster.stop()
    assert got["lost_s"] > 0 and got["recovered_s"] > 0
    assert sorted(got["sums"]) == sorted(names)


def test_ha_failover_drill_on_the_card(cuda, tmp_path):
    """``chip_smoke.py``'s 2k (a-b) at 4 x 1 MiB: three HA masters on
    EMBEDDED journals and a worker, each a process; the files written
    CACHE_THROUGH and an epoch onto the card, then a second epoch beside
    a writer child with the primary SIGKILLed after 2 consumed blocks:
    every block's sum the first epoch's (each launch held against the
    plain version), every acknowledged create on the new leader."""
    smoke = _smoke()
    block = 1 << 20
    files = {}
    for i in range(4):
        path = str(tmp_path / f"shard-{i}.blk")
        np.random.default_rng(i).integers(
            -2**31, 2**31 - 1, size=block // 4, dtype=np.int32).tofile(path)
        files[f"/ha/s-{i}"] = path
    cluster, leader_s = smoke.start_ha_cluster(str(tmp_path), block,
                                               16 * block)
    try:
        before = rk.launches
        got = smoke.failover_drill(cuda, cluster, files, 2, str(tmp_path))
        assert rk.launches - before == 8
    finally:
        cluster.stop()
    assert not any(p.alive for p in cluster.masters + cluster.workers)
    assert leader_s > 0 and got["watch"].registered_s > 0
    assert got["first"]["sums"] == got["second"]["sums"]
    assert got["acks"] and got["leader"] != \
        f"localhost:{cluster.master_ports[got['primary']]}"


def test_shells_drive_the_loader_on_the_card(cuda, tmp_path):
    """``chip_smoke.py``'s 2l (a-c) at 4 x 1 MiB: on a process cluster
    whose launched master reaches a job master of its own, the shells (each
    a child process) copy the corpus in, check and persist it; an epoch
    onto the card sums every block on the SHM rung; ``fs free`` drops it
    from the worker, ``fs distributedLoad`` brings it back, and a second
    epoch's sums equal the first's (each launch held against the plain
    version and numpy)."""
    from alluxio_tpu_torch.minicluster.multi_process import (
        MultiProcessCluster, free_port,
    )

    smoke = _smoke()
    block = 1 << 20
    files = smoke.shell_corpus(str(tmp_path / "corpus"), 4, block)
    job_port = free_port()
    cluster = MultiProcessCluster(
        str(tmp_path / "c"), num_workers=1, extra_conf={
            "atpu.user.block.size.bytes.default": str(block),
            **smoke.shell_cluster_conf(job_port)})
    cluster.start()
    roles = []
    try:
        roles = smoke.start_job_roles(cluster, job_port)
        fs = smoke.shell_client(cluster)
        try:
            before = rk.launches
            got = smoke.shell_drill(
                cuda, smoke.shell_context(cluster, job_port, str(tmp_path)),
                fs, files, str(tmp_path / "corpus"), block)
            assert rk.launches - before == 8
        finally:
            fs.close()
    finally:
        smoke.stop_job_roles(roles)
        cluster.stop()
    assert not any(p.alive for p in cluster.masters + cluster.workers)
    assert got["persisted_s"] >= 0 and got["used_drop_bytes"] >= 4 * block
    assert got["epoch1"]["sums"] == got["epoch2"]["sums"]
    assert sorted(got["epoch1"]["sums"]) == sorted(files)


def test_serving_surfaces_on_the_card(cuda):
    """``chip_smoke.py``'s 2o at 4 x 2 MiB: a log server, a process
    cluster shipping to it, the proxy and the FUSE child launched by the
    shell; every block read through the FUSE layer and through the
    proxy's ranged GETs is scanned on the card (each launch held against
    the plain version and numpy), a Hive table's int32 columns too, and
    every role's records reach the log server."""
    smoke = _smoke()
    smoke.BLOCK_BYTES = 2 << 20
    smoke.SERVE_SHARDS = 4
    smoke.SERVE_HIVE_ROWS = 1 << 16
    smoke.SERVE_RANGE_BYTES = 1 << 20
    got = smoke.serving_phase(cuda, {"epoch1_s": 1.0}, 50.0)
    assert got["launches"] == 4 + 4 + 2
    assert got["fuse"]["launches"] == got["proxy"]["launches"] == 4
    assert got["audit"]["inversions"] == 0
