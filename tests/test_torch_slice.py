"""The slice end to end at a small size, on the CPU, against the JAX
package: cluster -> both loaders -> device tier -> the chained
``scaled_sum`` consume (K=3, exact) and the decode batches (labels exact,
bf16 images bit for bit)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from alluxio_tpu.client.jax_io import \
    DeviceBlockLoader as JaxDeviceBlockLoader  # noqa: E402
from alluxio_tpu.client.jax_io import \
    batched_device_iterator as jax_batched  # noqa: E402
from alluxio_tpu.minicluster import LocalCluster  # noqa: E402
from alluxio_tpu.ops import decode as jax_decode  # noqa: E402
from alluxio_tpu.ops import reduce_kernel as jax_rk  # noqa: E402
from alluxio_tpu_torch.client.torch_io import (  # noqa: E402
    DeviceBlockLoader, batched_device_iterator,
)
from alluxio_tpu_torch.metrics import metrics  # noqa: E402
from alluxio_tpu_torch.ops import decode  # noqa: E402
from alluxio_tpu_torch.ops import reduce_kernel as rk  # noqa: E402

BLOCK = 64 * 1024
K = 3


@pytest.fixture()
def cluster(tmp_path):
    with LocalCluster(str(tmp_path), num_workers=1,
                      block_size=BLOCK) as c:
        yield c


def _jax_chain(blocks, k, rows):
    # the body of bench.py's consume_pallas, with the kernel interpreted
    x = jax_rk.pad_to_kernel_shape(jnp.concatenate(blocks).reshape(-1),
                                   rows=rows)
    acc = jnp.int32(0)
    for _ in range(k):
        acc = (jax_rk.scaled_sum(x, acc % 3 + 1, rows=rows,
                                 interpret=True) + acc) % 1000003
    return int(acc)


def _torch_chain(blocks, k, rows):
    x = rk.pad_to_kernel_shape(torch.cat(blocks), rows=rows)
    acc = torch.zeros((), dtype=torch.int32)
    for _ in range(k):
        acc = torch.remainder(
            rk.scaled_sum(x, torch.remainder(acc, 3) + 1, rows=rows) + acc,
            1000003)
    return int(acc)


def test_warm_tier_scan_matches_jax(cluster):
    fs = cluster.file_system()
    rng = np.random.default_rng(21)
    paths = []
    for i in range(3):
        raw = rng.integers(-2**31, 2**31 - 1, size=2 * BLOCK // 4,
                           dtype=np.int32).tobytes()
        fs.write_all(f"/slice/shard-{i}", raw)
        paths.append(f"/slice/shard-{i}")
    hbm = 8 * BLOCK
    jl = JaxDeviceBlockLoader(fs, paths, hbm_bytes=hbm, dtype=np.int32)
    tl = DeviceBlockLoader(fs, paths, device="cpu", hbm_bytes=hbm,
                           prefetch=2, dtype=np.int32)
    try:
        list(jl.epoch())
        list(tl.epoch())
        hits0 = metrics().counter("Client.JaxHbmHits").count
        jblocks = list(jl.epoch())
        tblocks = list(tl.epoch())
        # the second epoch is served wholly from the device tier
        assert metrics().counter("Client.JaxHbmHits").count - hits0 \
            == len(tl) == 6
        want = _jax_chain(jblocks, K, rows=512)
        got = _torch_chain(tblocks, K, rows=512)
        assert got == want
    finally:
        jl.close()
        tl.close()


def test_decode_batches_match_jax(cluster):
    fs = cluster.file_system()
    h = w = 8
    rb = decode.image_record_bytes(h, w)
    per_block = BLOCK // rb
    rng = np.random.default_rng(22)
    paths = []
    for i in range(2):
        imgs = rng.integers(0, 256, size=(per_block, h, w, 3),
                            dtype=np.uint8)
        labels = rng.integers(0, 1 << 30, size=per_block, dtype=np.int32)
        raw = decode.encode_image_records(imgs, labels)
        raw += b"\0" * (BLOCK - len(raw))
        fs.write_all(f"/slice/e2e-{i}", raw)
        paths.append(f"/slice/e2e-{i}")
    jl = JaxDeviceBlockLoader(fs, paths, hbm_bytes=4 * BLOCK)
    tl = DeviceBlockLoader(fs, paths, device="cpu", hbm_bytes=4 * BLOCK)
    try:
        want = list(jax_batched(jl, record_bytes=rb, batch_size=32))
        got = list(batched_device_iterator(tl, record_bytes=rb,
                                           batch_size=32))
        assert len(got) == len(want) == (2 * per_block) // 32
        for g, wnt in zip(got, want):
            assert g.numpy().tobytes() == np.asarray(wnt).tobytes()
            gi, glab = decode.decode_image_records(g, height=h, width=w)
            wi, wlab = jax_decode.decode_image_records(wnt, height=h,
                                                       width=w)
            np.testing.assert_array_equal(glab.numpy(), np.asarray(wlab))
            np.testing.assert_array_equal(
                gi.view(torch.int16).numpy().view(np.uint16),
                np.asarray(wi).view(np.uint16))
    finally:
        jl.close()
        tl.close()
