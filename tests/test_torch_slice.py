"""The slices end to end at a small size, on the CPU, against the JAX
package: cluster -> both loaders -> device tier -> the chained
``scaled_sum`` consume (K=3, exact) and the decode batches (labels exact,
bf16 images bit for bit); then decode -> ``images_to_tokens`` -> three
bf16 ViT train steps in each package from the same weights (losses to
2**-5 relative, the bf16 forward/backward tolerance of
``test_torch_transformer.py``; the parameters after the steps as
``test_torch_train.py`` holds them: per tensor, the norm of the
difference within 2**-5 of the tensor's norm, and per element within
Adam's step bound of 2 x lr a step), and the train state checkpointed on
the cluster by each package and restored by the other, bit for bit."""

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
from alluxio_tpu.models import checkpoint as jck  # noqa: E402
from alluxio_tpu.models import train as jtrain  # noqa: E402
from alluxio_tpu.models import transformer as jt  # noqa: E402
from alluxio_tpu.ops import decode as jax_decode  # noqa: E402
from alluxio_tpu.ops import reduce_kernel as jax_rk  # noqa: E402
from alluxio_tpu.parallel.mesh import make_mesh  # noqa: E402
from alluxio_tpu_torch import convert  # noqa: E402
from alluxio_tpu_torch.client.torch_io import (  # noqa: E402
    DeviceBlockLoader, batched_device_iterator,
)
from alluxio_tpu_torch.metrics import metrics  # noqa: E402
from alluxio_tpu_torch.models import checkpoint as tck  # noqa: E402
from alluxio_tpu_torch.models import train as ttrain  # noqa: E402
from alluxio_tpu_torch.models import transformer as tt  # noqa: E402
from alluxio_tpu_torch.ops import decode  # noqa: E402
from alluxio_tpu_torch.ops import reduce_kernel as rk  # noqa: E402
from alluxio_tpu_torch.utils.pytree import tree_leaves  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

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


def _raw(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def test_vit_train_steps_and_checkpoints_match_jax(cluster):
    fs = cluster.file_system()
    h = w = 32
    rb = decode.image_record_bytes(h, w)
    per_block = BLOCK // rb
    rng = np.random.default_rng(23)
    paths = []
    for i in range(2):
        imgs = rng.integers(0, 256, size=(per_block, h, w, 3),
                            dtype=np.uint8)
        labels = rng.integers(0, 10, size=per_block, dtype=np.int32)
        raw = decode.encode_image_records(imgs, labels)
        fs.write_all(f"/slice/vit-{i}", raw + b"\0" * (BLOCK - len(raw)))
        paths.append(f"/slice/vit-{i}")
    small = dict(vocab_or_patch_dim=768, d_model=32, n_heads=4, d_ff=64,
                 n_layers=2, n_classes=10, max_len=4)
    jcfg = jt.TransformerConfig(**small)
    tcfg = tt.TransformerConfig(**small)
    assert jcfg.dtype == jnp.bfloat16 and tcfg.dtype == torch.bfloat16
    mesh = make_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    params, opt, tx, shardings = jtrain.make_sharded_train_state(jcfg, mesh)
    jstep = jtrain.make_train_step(jcfg, mesh, tx, shardings)
    model = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, device="cpu")
    state = convert.opt_state_from_numpy(jax.tree.map(np.asarray, opt),
                                         model.leaves())
    lr = 1e-3  # both packages' default
    tstep = ttrain.make_train_step(tcfg, ttrain.adamw(lr))
    jl = JaxDeviceBlockLoader(fs, paths, hbm_bytes=4 * BLOCK)
    tl = DeviceBlockLoader(fs, paths, device="cpu", hbm_bytes=4 * BLOCK)
    try:
        jb = jax_batched(jl, record_bytes=rb, batch_size=8)
        tb = batched_device_iterator(tl, record_bytes=rb, batch_size=8)
        for _ in range(3):
            ji, jlab = jax_decode.decode_image_records(next(jb), height=h,
                                                       width=w)
            ti, tlab = decode.decode_image_records(next(tb), height=h,
                                                   width=w)
            jtok = jt.images_to_tokens(ji)
            ttok = tt.images_to_tokens(ti)
            np.testing.assert_array_equal(
                ttok.view(torch.int16).numpy().view(np.uint16),
                np.asarray(jtok).view(np.uint16))
            params, opt, jloss = jstep(params, opt, jtok, jlab)
            model, state, loss = tstep(model, state, ttok, tlab)
            np.testing.assert_allclose(float(loss), float(jloss),
                                       rtol=2.0 ** -5)
        jb.close()
        tb.close()
    finally:
        jl.close()
        tl.close()
    for got, want in zip(model.leaves(), jax.tree_util.tree_leaves(params)):
        want = np.asarray(want.astype(jnp.float32))
        diff = got.detach().float().numpy() - want
        assert np.linalg.norm(diff) <= 2.0 ** -5 * np.linalg.norm(want)
        assert np.abs(diff).max() <= 2 * lr * 3

    # JAX writes, the port restores
    jck.save_train_state(fs, "/ckpt/jax/step-3", params, opt, step=3)
    assert tck.latest_step(fs, "/ckpt/jax") == 3
    assert tck.latest_step(fs, "/ckpt/none") is None
    fresh, fresh_opt, _ = ttrain.make_train_state(tcfg, device="cpu",
                                                  seed=4)
    got_p, got_o, at = tck.load_train_state(
        fs, "/ckpt/jax/step-3", like_params=fresh.param_tree(),
        like_opt=fresh_opt)
    assert at == 3
    for g, want in zip(tree_leaves((got_p, got_o)),
                       jax.tree_util.tree_leaves((params, opt))):
        assert _raw(g) == _raw(want)
    # the port writes, JAX restores
    tck.save_train_state(fs, "/ckpt/port/step-3", model.param_tree(),
                         state, step=3)
    assert jck.latest_step(fs, "/ckpt/port") == 3
    jp, jo, at = jck.load_train_state(fs, "/ckpt/port/step-3",
                                      like_params=params, like_opt=opt)
    assert at == 3
    for g, want in zip(jax.tree_util.tree_leaves((jp, jo)),
                       tree_leaves((model.param_tree(), state))):
        assert _raw(g) == _raw(want)
