"""Ring attention, the expert-parallel MoE and the pipeline of the port
across gloo ranks, against the JAX package on the fake CPU devices.

One module-scoped fixture spawns a group of 4 ranks and one of 2
(``tests/testutils/torch_dist.py``). Tolerances, all float32: ring
attention within 1e-5 of JAX's ``ring_attention`` and of
``reference_attention`` (the same products, merged blockwise); the MoE
output and gradients within 1e-5 of JAX's (the combine sums one
non-zero expert per token, the gradients differ by summation order);
the pipeline exactly equal to the port's stages run in sequence (the
same ops; the final all-reduce adds zeros) and within 1e-6 of JAX's
``pipeline_apply``. The workers import only torch, numpy and the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alluxio_tpu_torch.parallel import moe as tmoe  # noqa: E402
from alluxio_tpu_torch.parallel.mesh import (Layout, make_mesh,  # noqa: E402
                                             shard)
from alluxio_tpu_torch.parallel.pipeline import pipeline_apply  # noqa: E402
from alluxio_tpu_torch.parallel.ring_attention import (  # noqa: E402
    reference_attention, ring_attention)
from tests.testutils.torch_dist import run_groups  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

RING = (2, 32, 2, 8)                     # [B, T, H, D], T over 4 ranks
MOE = dict(n_experts=4, d_model=16, d_ff=32)
MOE_X = (4, 8, 16)
PIPE_D, PIPE_M = 8, 4                    # width, microbatches


def ring_inputs():
    rng = np.random.default_rng(30)
    return [rng.standard_normal(RING).astype(np.float32) for _ in range(3)]


def moe_inputs():
    rng = np.random.default_rng(31)
    params = {
        "gate": rng.standard_normal((16, 4)).astype(np.float32) * 0.25,
        "w_in": rng.standard_normal((4, 16, 32)).astype(np.float32) * 0.25,
        "w_out": rng.standard_normal((4, 32, 16)).astype(np.float32) * 0.18,
    }
    x = rng.standard_normal(MOE_X).astype(np.float32)
    upstream = rng.standard_normal(MOE_X).astype(np.float32)
    return params, x, upstream


def pipe_inputs(stages):
    rng = np.random.default_rng(32 + stages)
    params = {"w": (rng.standard_normal((stages, PIPE_D, PIPE_D)) * 0.3)
              .astype(np.float32),
              "b": (rng.standard_normal((stages, PIPE_D)) * 0.1)
              .astype(np.float32)}
    micro = rng.standard_normal((PIPE_M, 2, PIPE_D)).astype(np.float32)
    return params, micro


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def run_pipeline(stages):
    params, micro = pipe_inputs(stages)
    mesh = make_mesh({"pipe": stages}, device_type="cpu")
    lay = Layout(0, "pipe")
    mine = {k: shard(torch.from_numpy(v), lay, mesh)
            for k, v in params.items()}
    return pipeline_apply(stage_fn, mine, torch.from_numpy(micro),
                          mesh=mesh).numpy()


def four(rank, world, out_dir):
    out = {}
    # ring attention over the 4 ranks: this rank's T-shard in and out
    mesh = make_mesh({"data": world}, device_type="cpu")
    t = RING[1] // world
    q, k, v = (torch.from_numpy(a[:, rank * t:(rank + 1) * t])
               for a in ring_inputs())
    for causal in (True, False):
        out[f"ring_{causal}"] = ring_attention(
            q, k, v, mesh=mesh, axis="data", causal=causal).numpy()
    # the MoE, data 2 x model 2: this rank's rows and experts
    mesh = make_mesh({"data": 2, "model": 2}, device_type="cpu")
    params, x, upstream = moe_inputs()
    d = mesh.get_local_rank("data")
    rows = slice(d * 2, (d + 1) * 2)
    mine = {name: p.requires_grad_() for name, p in tmoe.shard_moe_params(
        {k: torch.from_numpy(v) for k, v in params.items()}, mesh).items()}
    xl = torch.from_numpy(x[rows]).requires_grad_()
    y = tmoe.moe_ffn(mine, xl, mesh=mesh)
    grads = torch.autograd.grad((y * torch.from_numpy(upstream[rows])).sum(),
                                [xl, *mine.values()])
    out["moe_y"] = y.detach().numpy()
    out["moe_grads"] = [g.numpy() for g in grads]
    aux = tmoe.load_balance_loss(mine, xl, group=mesh.get_group("data"))
    out["aux"] = float(aux)
    out["aux_gate_grad"] = torch.autograd.grad(aux, mine["gate"])[0].numpy()
    out["pipe4"] = run_pipeline(world)
    return out


def two(rank, world, out_dir):
    return {"pipe2": run_pipeline(world)}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_groups(__name__, {"w4": (4, "four"), "w2": (2, "two")},
                      tmp_path_factory.mktemp("parallel"))


def _jax():
    import importlib

    import jax

    # ``alluxio_tpu.parallel`` re-exports a function named
    # ``ring_attention``: import the module itself
    return jax, importlib.import_module(
        "alluxio_tpu.parallel.ring_attention")


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(port, causal):
    jax, jra = _jax()
    from alluxio_tpu.parallel.mesh import make_mesh as jax_mesh

    q, k, v = ring_inputs()
    mesh = jax_mesh({"data": 4}, devices=jax.devices()[:4])
    want = np.asarray(jra.ring_attention(q, k, v, mesh=mesh, axis="data",
                                         causal=causal))
    ref = np.asarray(jra.reference_attention(q, k, v, causal=causal))
    got = np.concatenate([r[f"ring_{causal}"] for r in port["w4"]], axis=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    mine = reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal).numpy()
    np.testing.assert_allclose(got, mine, rtol=0, atol=1e-5)


def _jax_moe():
    import jax
    import jax.numpy as jnp

    from alluxio_tpu.parallel import moe as jmoe
    from alluxio_tpu.parallel.mesh import make_mesh as jax_mesh
    from alluxio_tpu.parallel.mesh import named_sharding

    params, x, upstream = moe_inputs()
    mesh = jax_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    sh = jmoe.moe_param_shardings(mesh)
    sharded = {k: jax.device_put(jnp.asarray(v), sh[k])
               for k, v in params.items()}
    xs = jax.device_put(jnp.asarray(x), named_sharding(mesh, "data"))

    def loss(p, x):
        return (jmoe.moe_ffn(p, x) * upstream).sum()

    y = np.asarray(jax.jit(jmoe.moe_ffn)(sharded, xs))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(sharded, xs)
    aux, aux_grad = jax.value_and_grad(jmoe.load_balance_loss)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return y, gp, gx, float(aux), np.asarray(aux_grad["gate"])


def test_moe_expert_parallel_matches_jax(port):
    y, gp, gx, _aux, _g = _jax_moe()
    ranks = port["w4"]  # rank = 2 * data + model
    got = np.concatenate([ranks[0]["moe_y"], ranks[2]["moe_y"]])
    np.testing.assert_allclose(got, y, rtol=0, atol=1e-5)
    for d in range(2):  # both model ranks of a data rank hold its rows
        np.testing.assert_array_equal(ranks[2 * d]["moe_y"],
                                      ranks[2 * d + 1]["moe_y"])
    # x's gradient: its rows' whole gradient on every model rank (the
    # copy-to sums the expert path over the group)
    gx = np.asarray(gx)
    for r_i, r in enumerate(ranks):
        d = r_i // 2
        np.testing.assert_allclose(r["moe_grads"][0], gx[d * 2:(d + 1) * 2],
                                   rtol=0, atol=1e-5)
    # the gate is whole on every rank: its gradient from this rank's
    # rows, not summed over model; the data ranks' sum is JAX's
    gate = ranks[0]["moe_grads"][1] + ranks[2]["moe_grads"][1]
    np.testing.assert_allclose(gate, np.asarray(gp["gate"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(ranks[0]["moe_grads"][1],
                                  ranks[1]["moe_grads"][1])
    # experts: model rank m holds experts [2m, 2m+2); data ranks sum
    for name, i in (("w_in", 2), ("w_out", 3)):
        want = np.asarray(gp[name])
        for m in range(2):
            got = ranks[m]["moe_grads"][i] + ranks[2 + m]["moe_grads"][i]
            np.testing.assert_allclose(got, want[2 * m:2 * m + 2], rtol=0,
                                       atol=1e-5)


def test_balance_loss_over_the_data_group_matches_jax(port):
    *_, aux, aux_gate = _jax_moe()
    ranks = port["w4"]
    for r in ranks:
        np.testing.assert_allclose(r["aux"], aux, rtol=1e-6)
    # each rank's gradient covers its rows with the whole batch's means;
    # the data-parallel mean of the gradients is the whole gradient
    got = (ranks[0]["aux_gate_grad"] + ranks[2]["aux_gate_grad"]) / 2
    np.testing.assert_allclose(got, aux_gate, rtol=0, atol=1e-5)


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_matches_jax_and_stages_in_sequence(port, stages):
    import jax
    import jax.numpy as jnp

    from alluxio_tpu.parallel.mesh import make_mesh as jax_mesh
    from alluxio_tpu.parallel.pipeline import pipeline_apply as jax_apply

    params, micro = pipe_inputs(stages)
    seq = torch.from_numpy(micro)
    for s in range(stages):
        seq = stage_fn({k: torch.from_numpy(v[s]) for k, v in
                        params.items()}, seq)
    mesh = jax_mesh({"pipe": stages}, devices=jax.devices()[:stages])
    want = np.asarray(jax_apply(
        lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(micro),
        mesh=mesh))
    for r in port[f"w{stages}"]:
        got = r[f"pipe{stages}"]
        np.testing.assert_array_equal(got, seq.numpy())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
