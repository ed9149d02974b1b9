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
