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
            stream = LocalBlockInStream(files[p], os.path.getsize(files[p]))
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
    import importlib.util
    from pathlib import Path

    import torch.distributed as dist

    from alluxio_tpu_torch.parallel.mesh import make_mesh

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
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
