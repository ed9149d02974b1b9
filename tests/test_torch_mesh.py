"""The port's mesh layer on gloo ranks: the mesh's coordinates, layouts
(``shard``/``gather``), ``shard_host_batch`` and the two tensor-parallel
autograd Functions, against the JAX package's mesh on the fake CPU
devices.

One module-scoped fixture spawns a group of 4 ranks
(``tests/testutils/torch_dist.py``) and each test reads what the ranks
saw. Byte moves are exact; the tensor-parallel Functions' outputs and
gradients are held within 1e-5 of each tensor's largest magnitude
(float32) of JAX's gradient of the same unsplit products (a split
product sums in another order). The workers import only torch, numpy
and the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alluxio_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from alluxio_tpu_torch.parallel.tensor_parallel import (  # noqa: E402
    copy_to_group, reduce_from_group)
from tests.testutils.torch_dist import run_groups  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

LAYOUTS = {"replicated": tmesh.REPLICATED,
           "dim0-data": tmesh.Layout(0, "data"),
           "dim1-model": tmesh.Layout(1, "model"),
           "dim2-model": tmesh.Layout(2, "model")}
FULL = np.arange(4 * 6 * 4, dtype=np.float32).reshape(4, 6, 4)


def megatron_inputs():
    rng = np.random.default_rng(50)
    return (rng.standard_normal((3, 8)).astype(np.float32),
            rng.standard_normal((8, 6)).astype(np.float32),
            rng.standard_normal((6, 8)).astype(np.float32))


def four(rank, world, out_dir):
    mesh = tmesh.make_mesh({"data": 2, "model": 2}, device_type="cpu")
    out = {"coords": (tmesh.axis_rank(mesh, "data"),
                      tmesh.axis_rank(mesh, "model")),
           "sizes": (tmesh.axis_size(mesh, "data"),
                     tmesh.axis_size(mesh, "model")),
           "device": str(tmesh.mesh_device(mesh)),
           "identity": tmesh.identity_for_device(tmesh.mesh_device(mesh))}
    full = torch.from_numpy(FULL)
    out["shards"] = {name: tmesh.shard(full, lay, mesh).numpy()
                     for name, lay in LAYOUTS.items()}
    out["gathered"] = {name: tmesh.gather(tmesh.shard(full, lay, mesh),
                                          lay, mesh).numpy()
                       for name, lay in LAYOUTS.items()}
    out["host_batch"] = tmesh.shard_host_batch(mesh, FULL).numpy()
    # a Megatron MLP: columns of w1 and rows of w2 over model
    x, w1, w2 = (torch.from_numpy(a) for a in megatron_inputs())
    m = tmesh.axis_rank(mesh, "model")
    group = mesh.get_group("model")
    x = x.requires_grad_()
    w1 = w1[:, m * 3:(m + 1) * 3].clone().requires_grad_()
    w2 = w2[m * 3:(m + 1) * 3].clone().requires_grad_()
    y = reduce_from_group(torch.tanh(copy_to_group(x, group) @ w1) @ w2,
                          group)
    out["y"] = y.detach().numpy()
    out["grads"] = [g.numpy() for g in torch.autograd.grad(
        (y * y).sum(), [x, w1, w2])]
    out["default"] = tmesh.make_mesh(device_type="cpu").mesh_dim_names
    for name, call in (("bad_shape", lambda: tmesh.make_mesh(
            {"data": 3}, device_type="cpu")),
            ("cuda_over_gloo", lambda: tmesh.make_mesh(
                {"data": 4}, device_type="cuda")),
            ("uneven", lambda: tmesh.shard(torch.zeros(3, 2),
                                           tmesh.Layout(0, "data"), mesh))):
        try:
            call()
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_groups(__name__, {"w4": (4, "four")},
                      tmp_path_factory.mktemp("mesh"))["w4"]


def _jax_mesh():
    import jax

    from alluxio_tpu.parallel.mesh import make_mesh
    return make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])


def test_ranks_take_the_jax_mesh_positions(port):
    """Rank r sits where JAX's mesh puts device r of the list."""
    jmesh = _jax_mesh()
    for r, seen in enumerate(port):
        pos = np.argwhere(np.vectorize(lambda d: d.id)(jmesh.devices) == r)
        assert seen["coords"] == tuple(int(i) for i in pos[0])
        assert seen["sizes"] == (2, 2) and seen["device"] == "cpu"


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_shard_and_gather(port, name):
    lay = LAYOUTS[name]
    for seen in port:
        np.testing.assert_array_equal(seen["gathered"][name], FULL)
        got = seen["shards"][name]
        if lay.dim is None:
            np.testing.assert_array_equal(got, FULL)
            continue
        i = seen["coords"][0 if lay.axis == "data" else 1]
        n = FULL.shape[lay.dim] // 2
        np.testing.assert_array_equal(
            got, np.take(FULL, range(i * n, (i + 1) * n), axis=lay.dim))


def test_layout_of_a_partition_spec():
    from jax.sharding import PartitionSpec as P

    for spec, want in ((P(None, None, "model", None),
                        tmesh.Layout(2, "model")),
                       (P("model"), tmesh.Layout(0, "model")),
                       (P(None, "model"), tmesh.Layout(1, "model")),
                       (P(), tmesh.REPLICATED)):
        assert tmesh.layout(*spec) == want
    with pytest.raises(ValueError):
        tmesh.layout("data", "model")


def test_shard_host_batch_matches_jax(port):
    import jax

    from alluxio_tpu.parallel.mesh import shard_host_batch

    arr = shard_host_batch(_jax_mesh(), FULL)
    by_device = {s.device.id: np.asarray(s.data)
                 for s in arr.addressable_shards}
    for r, seen in enumerate(port):
        np.testing.assert_array_equal(seen["host_batch"], by_device[r])
    assert jax.devices()[0].id == 0


def test_tensor_parallel_functions_match_jax_gradients(port):
    import jax
    import jax.numpy as jnp

    x, w1, w2 = megatron_inputs()

    def loss(x, w1, w2):
        y = jnp.tanh(x @ w1) @ w2
        return (y * y).sum(), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(x, w1, w2)
    gx, g1, g2 = (np.asarray(g) for g in grads)

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

    for seen in port:
        m = seen["coords"][1]
        close(seen["y"], np.asarray(y))
        got_x, got_1, got_2 = seen["grads"]
        close(got_x, gx)
        close(got_1, g1[:, m * 3:(m + 1) * 3])
        close(got_2, g2[m * 3:(m + 1) * 3])


def test_identity_matches_jax_for_a_cpu_device(port):
    import jax

    from alluxio_tpu.parallel.mesh import identity_for_device

    want = identity_for_device(jax.devices()[0])
    for seen in port:
        got = seen["identity"]
        assert [(t.tier, t.value) for t in got.tiers] == \
            [(t.tier, t.value) for t in want.tiers]
    card = tmesh.identity_for_device("cuda:0")
    assert card.value("host") == "host-0" and card.value("slice") == \
        "slice-0"


def test_make_mesh_refuses_what_it_cannot_build(port):
    for seen in port:
        assert seen["default"] == ("data",)
        assert seen["bad_shape"].startswith("ValueError: mesh shape")
        assert "nccl backend" in seen["cuda_over_gloo"]
        assert seen["uneven"].startswith("ValueError")
