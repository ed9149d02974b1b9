"""Gradients through the port's ring attention, pipeline and
sequence-parallel transformer across gloo ranks, against ``jax.grad``
through the JAX package on the fake CPU devices.

One module-scoped fixture takes the JAX initial parameters of the
small transformer (dense and MoE) to numpy, then spawns a group of 4
ranks and one of 2 (``tests/testutils/torch_dist.py``); inputs and
upstream gradients come from numpy seeds. Tolerances, all float32:

- ring attention: dq, dk and dv within 1e-5 absolute of ``jax.grad``
  through ``ring_attention`` (the same products, summed in another
  order), causal and not, at 4 and 2 ranks;
- the pipeline: each rank's stage slice of every parameter's gradient,
  and the microbatches' gradient on every rank, within 1e-6 absolute of
  ``jax.grad`` through ``pipeline_apply``, at 4 and 2 stages;
- the transformer under ``seq_axis="data"`` at 2 ranks: each shard's
  loss and each shard's gradient of every parameter within 1e-5,
  relative and absolute (the float32 bound of
  ``tests/test_torch_transformer.py``), of JAX's ``value_and_grad`` of
  ``loss_fn`` inside ``shard_map``, stacked by shard so every rank is
  checked; dense and MoE.

The sequence-parallel forward keeps three oddities of the reference
(local positions, local pooling, a local MoE balance loss): the last
test pins that a shard's loss differs from the single-device loss in
both packages, and that the packages agree on it. The workers import
only torch, numpy and the port.
"""

import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alluxio_tpu_torch import convert  # noqa: E402
from alluxio_tpu_torch.models import transformer as tt  # noqa: E402
from alluxio_tpu_torch.parallel.mesh import (Layout, make_mesh,  # noqa: E402
                                             shard)
from alluxio_tpu_torch.parallel.pipeline import pipeline_apply  # noqa: E402
from alluxio_tpu_torch.parallel.ring_attention import (  # noqa: E402
    ring_attention)
from tests.testutils.torch_dist import run_groups  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

RING = (2, 32, 2, 8)                     # [B, T, H, D], T over the ranks
PIPE_D, PIPE_M = 8, 4                    # width, microbatches
SMALL = dict(vocab_or_patch_dim=48, d_model=32, n_heads=4, d_ff=64,
             n_layers=2, n_classes=10, max_len=16)
B, T = 4, 16                             # the transformer's batch
VARIANTS = {"dense": 0, "moe": 4}        # moe_experts
RING_ATOL, PIPE_ATOL, MODEL_TOL = 1e-5, 1e-6, 1e-5


def ring_inputs():
    rng = np.random.default_rng(40)
    return [rng.standard_normal(RING).astype(np.float32) for _ in range(4)]


def pipe_inputs(stages):
    rng = np.random.default_rng(41 + stages)
    params = {"w": (rng.standard_normal((stages, PIPE_D, PIPE_D)) * 0.3)
              .astype(np.float32),
              "b": (rng.standard_normal((stages, PIPE_D)) * 0.1)
              .astype(np.float32)}
    micro = rng.standard_normal((PIPE_M, 2, PIPE_D)).astype(np.float32)
    upstream = rng.standard_normal(micro.shape).astype(np.float32)
    return params, micro, upstream


def model_inputs():
    rng = np.random.default_rng(42)
    tokens = rng.standard_normal(
        (B, T, SMALL["vocab_or_patch_dim"])).astype(np.float32)
    labels = rng.integers(0, SMALL["n_classes"], B).astype(np.int32)
    return tokens, labels


def tcfg(variant):
    return tt.TransformerConfig(dtype=torch.float32,
                                moe_experts=VARIANTS[variant], **SMALL)


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def ring_grads(rank, world):
    mesh = make_mesh({"data": world}, device_type="cpu")
    t = RING[1] // world
    q, k, v, up = (torch.from_numpy(a[:, rank * t:(rank + 1) * t])
                   for a in ring_inputs())
    out = {}
    for causal in (True, False):
        qkv = [a.clone().requires_grad_() for a in (q, k, v)]
        y = ring_attention(*qkv, mesh=mesh, axis="data", causal=causal)
        grads = torch.autograd.grad((y * up).sum(), qkv)
        out[f"ring_{causal}"] = [g.numpy() for g in grads]
    return out


def pipeline_grads(world):
    params, micro, upstream = pipe_inputs(world)
    mesh = make_mesh({"pipe": world}, device_type="cpu")
    lay = Layout(0, "pipe")
    mine = {k: shard(torch.from_numpy(v), lay, mesh).requires_grad_()
            for k, v in params.items()}
    xs = torch.from_numpy(micro).requires_grad_()
    y = pipeline_apply(stage_fn, mine, xs, mesh=mesh)
    gw, gb, gx = torch.autograd.grad((y * torch.from_numpy(upstream)).sum(),
                                     [mine["w"], mine["b"], xs])
    return {"pipe_w": gw.numpy(), "pipe_b": gb.numpy(), "pipe_x": gx.numpy()}


def model_grads(rank, world, out_dir):
    inputs = pickle.loads((Path(out_dir) / "inputs.pkl").read_bytes())
    tokens, labels = model_inputs()
    mesh = make_mesh({"data": world, "model": 1}, device_type="cpu")
    t = T // world
    tok = torch.from_numpy(tokens[:, rank * t:(rank + 1) * t])
    out = {}
    for variant in VARIANTS:
        model = convert.transformer_params_from_numpy(
            inputs[variant], tcfg(variant), mesh=mesh)
        loss = tt.loss_fn(model, tok, torch.from_numpy(labels),
                          seq_axis="data")
        grads = torch.autograd.grad(loss, model.leaves())
        out[variant] = (loss.item(), [g.numpy() for g in grads])
    return out


def four(rank, world, out_dir):
    return {**ring_grads(rank, world), **pipeline_grads(world)}


def two(rank, world, out_dir):
    return {**ring_grads(rank, world), **pipeline_grads(world),
            "model": model_grads(rank, world, out_dir)}


def _jax_params(variant):
    import jax

    from alluxio_tpu.models import transformer as jt

    jcfg = jt.TransformerConfig(dtype=jax.numpy.float32,
                                moe_experts=VARIANTS[variant], **SMALL)
    params = jax.jit(jt.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(3))
    return jcfg, params


def jax_tree(params):
    import jax

    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("parallel_grad")
    trees = {v: jax_tree(_jax_params(v)[1]) for v in VARIANTS}
    (out_dir / "inputs.pkl").write_bytes(pickle.dumps(trees))
    return run_groups(__name__, {"w4": (4, "four"), "w2": (2, "two")},
                      out_dir)


def _shard_map(body, mesh, in_specs, out_specs):
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map
    try:
        return shard_map(body, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
    except TypeError:  # older jax spells it check_rep
        return shard_map(body, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_rep=False)


def _jax_mesh(n, axis):
    import jax

    from alluxio_tpu.parallel.mesh import make_mesh as jax_mesh

    return jax_mesh({axis: n}, devices=jax.devices()[:n])


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_grads_match_jax(port, world, causal):
    import importlib

    import jax

    # ``alluxio_tpu.parallel`` re-exports a function named
    # ``ring_attention``: import the module itself
    jra = importlib.import_module("alluxio_tpu.parallel.ring_attention")
    q, k, v, up = ring_inputs()
    mesh = _jax_mesh(world, "data")

    def loss(q, k, v):
        return (jra.ring_attention(q, k, v, mesh=mesh, axis="data",
                                   causal=causal) * up).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for i, name in enumerate("qkv"):
        got = np.concatenate([r[f"ring_{causal}"][i]
                              for r in port[f"w{world}"]], axis=1)
        np.testing.assert_allclose(got, np.asarray(want[i]), rtol=0,
                                   atol=RING_ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("stages", [4, 2])
def test_pipeline_grads_match_jax(port, stages):
    import jax
    import jax.numpy as jnp

    from alluxio_tpu.parallel.pipeline import pipeline_apply as jax_apply

    params, micro, upstream = pipe_inputs(stages)
    mesh = _jax_mesh(stages, "pipe")

    def loss(p, x):
        y = jax_apply(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), p, x,
                      mesh=mesh)
        return (y * upstream).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(micro))
    for s, r in enumerate(port[f"w{stages}"]):
        for name in ("w", "b"):
            np.testing.assert_allclose(
                r[f"pipe_{name}"], np.asarray(gp[name])[s:s + 1], rtol=0,
                atol=PIPE_ATOL, err_msg=f"stage {s} {name}")
        np.testing.assert_allclose(r["pipe_x"], np.asarray(gx), rtol=0,
                                   atol=PIPE_ATOL, err_msg=f"rank {s} x")


def _jax_seq_parallel(variant):
    """Each of 2 shards' loss and gradients, stacked by shard."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from alluxio_tpu.models import transformer as jt

    jcfg, params = _jax_params(variant)
    tokens, labels = model_inputs()

    def body(p, tok, lab):
        loss, grads = jax.value_and_grad(jt.loss_fn)(p, tok, lab, jcfg,
                                                     seq_axis="data")
        return loss[None], jax.tree.map(lambda g: g[None], grads)

    fn = _shard_map(body, _jax_mesh(2, "data"),
                    in_specs=(P(), P(None, "data", None), P()),
                    out_specs=(P("data"), P("data")))
    loss, grads = fn(params, jnp.asarray(tokens), jnp.asarray(labels))
    return np.asarray(loss), [np.asarray(g)
                              for g in jax.tree_util.tree_leaves(grads)]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_seq_parallel_transformer_grads_match_jax(port, variant):
    losses, grads = _jax_seq_parallel(variant)
    for rank, r in enumerate(port["w2"]):
        loss, mine = r["model"][variant]
        np.testing.assert_allclose(loss, losses[rank], rtol=MODEL_TOL,
                                   atol=MODEL_TOL)
        assert len(mine) == len(grads)
        for i, (got, want) in enumerate(zip(mine, grads)):
            np.testing.assert_allclose(got, want[rank], rtol=MODEL_TOL,
                                       atol=MODEL_TOL,
                                       err_msg=f"rank {rank} leaf {i}")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_seq_parallel_loss_is_the_shards_own_in_both_packages(port,
                                                              variant):
    """The reference's sequence-parallel loss is not the single-device
    loss (local positions and pooling, a local balance loss); the port
    computes the same per-shard losses."""
    import jax.numpy as jnp

    from alluxio_tpu.models import transformer as jt

    jcfg, params = _jax_params(variant)
    tokens, labels = model_inputs()
    jax_whole = float(jt.loss_fn(params, jnp.asarray(tokens),
                                 jnp.asarray(labels), jcfg))
    model = convert.transformer_params_from_numpy(
        jax_tree(params), tcfg(variant), device="cpu")
    port_whole = tt.loss_fn(model, torch.from_numpy(tokens),
                            torch.from_numpy(labels)).item()
    np.testing.assert_allclose(port_whole, jax_whole, rtol=MODEL_TOL)
    jax_shards, _ = _jax_seq_parallel(variant)
    port_shards = [r["model"][variant][0] for r in port["w2"]]
    np.testing.assert_allclose(port_shards, jax_shards, rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    for loss in port_shards:
        assert abs(loss - port_whole) > 1e-3, (port_shards, port_whole)

