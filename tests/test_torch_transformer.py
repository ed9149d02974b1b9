"""The port's flagship model against the JAX package on the CPU: the same
numpy-seeded inputs and the same weights (JAX ``init_params`` carried
over through ``convert.py``) through both.

Tolerances: float32 is held to 1e-5 (the two differ only in summation
order). bf16 keeps 8 significant bits, so one rounding is worth up to
2**-9 relative; the packages round at different places (XLA keeps
float32 across a fused chain of bf16 ops where PyTorch rounds after
each op), so a bf16 result is held to a few of its own ulps, measured
against the largest magnitude in the compared tensor: 2**-7 (4 ulps)
for one op (attention, RMS norm), 2**-5 after the two layers of a
forward or a backward, where those roundings compound (measured:
logits 2**-7.6, the worst gradient leaf 2**-6.5).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from alluxio_tpu.models import transformer as jt  # noqa: E402
from alluxio_tpu_torch import convert  # noqa: E402
from alluxio_tpu_torch.models import transformer as tt  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

# both packages' parallel/__init__ re-export a function under the
# module's name, so take the modules themselves
jra = importlib.import_module("alluxio_tpu.parallel.ring_attention")
tra = importlib.import_module("alluxio_tpu_torch.parallel.ring_attention")

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -5)}
SMALL = dict(vocab_or_patch_dim=48, d_model=32, n_heads=4, d_ff=64,
             n_layers=2, n_classes=10, max_len=16)
B, T = 4, 16


def configs(name, **extra):
    jdt, tdt, _ = DTYPES[name]
    return (jt.TransformerConfig(dtype=jdt, **SMALL, **extra),
            tt.TransformerConfig(dtype=tdt, **SMALL, **extra))


def carried(jcfg, tcfg, seed=0):
    params = jax.jit(jt.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, convert.transformer_params_from_numpy(tree, tcfg,
                                                         device="cpu")


def to_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x).astype(np.float32)


def assert_close(got, want, tol):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    if tol > 1e-4:  # bf16: ulps at the tensor's largest magnitude
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * float(np.abs(want).max()))
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def tokens(seed, dtype_name):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, SMALL["vocab_or_patch_dim"]))
    jdt, tdt, _ = DTYPES[dtype_name]
    return jnp.asarray(x, jdt), torch.from_numpy(
        np.asarray(jnp.asarray(x, jnp.float32))).to(tdt)


def test_param_names_and_shapes_match_the_jax_tree():
    jcfg, tcfg = configs("float32")
    params, model = carried(jcfg, tcfg)
    want = {jax.tree_util.keystr(k, simple=True, separator="."): v.shape
            for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    # the flatten order is JAX's, leaf for leaf
    for a, p in zip(jax.tree_util.tree_leaves(params), model.leaves()):
        np.testing.assert_array_equal(np.asarray(a), p.detach().numpy())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention(dtype, causal):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(1)
    qkv = [rng.standard_normal((B, T, 4, 8)).astype(np.float32)
           for _ in range(3)]
    want = jra.reference_attention(*[jnp.asarray(a, jdt) for a in qkv],
                                   causal=causal)
    got = tra.reference_attention(
        *[torch.from_numpy(np.asarray(jnp.asarray(a, jdt).astype(
            jnp.float32))).to(tdt) for a in qkv], causal=causal)
    assert got.dtype == tdt
    assert_close(got, want, 1e-5 if dtype == "float32" else 2.0 ** -7)


def test_causal_bias_matches():
    want = np.asarray(jra._causal_bias(5, 7, 3, 1, jnp.float32))
    got = tra._causal_bias(5, 7, 3, 1, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rms_norm(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((B, T, 32)) * 3, jdt)
    s = jnp.asarray(rng.standard_normal(32), jdt)
    want = jt._rms_norm(x, s)
    got = tt._rms_norm(torch.from_numpy(np.asarray(x.astype(jnp.float32)))
                       .to(tdt), torch.from_numpy(
                           np.asarray(s.astype(jnp.float32))).to(tdt))
    assert got.dtype == tdt
    assert_close(got, want, 1e-5 if dtype == "float32" else 2.0 ** -7)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_with_aux_dense(dtype):
    jcfg, tcfg = configs(dtype)
    params, model = carried(jcfg, tcfg)
    jx, tx = tokens(3, dtype)
    want_logits, want_aux = jax.jit(jt.forward_with_aux, static_argnums=2)(
        params, jx, jcfg)
    with torch.no_grad():
        logits, aux = tt.forward_with_aux(model, tx)
    assert logits.dtype == torch.float32 and logits.shape == (B, 10)
    assert_close(logits, want_logits, DTYPES[dtype][2])
    assert float(aux) == float(want_aux) == 0.0


def test_forward_with_aux_moe():
    # float32, so near-tie argmax routing cannot flip between packages
    jcfg, tcfg = configs("float32", moe_experts=4)
    params, model = carried(jcfg, tcfg)
    jx, tx = tokens(4, "float32")
    want_logits, want_aux = jax.jit(jt.forward_with_aux, static_argnums=2)(
        params, jx, jcfg)
    with torch.no_grad():
        logits, aux = tt.forward_with_aux(model, tx)
    assert_close(logits, want_logits, 1e-5)
    assert_close(aux, want_aux, 1e-5)
    assert float(aux) > 0


@pytest.mark.parametrize("dtype,moe", [("float32", 0), ("bfloat16", 0),
                                       ("float32", 4)])
def test_loss_and_gradients(dtype, moe):
    jcfg, tcfg = configs(dtype, moe_experts=moe)
    params, model = carried(jcfg, tcfg)
    jx, tx = tokens(5, dtype)
    labels = np.random.default_rng(6).integers(0, 10, B).astype(np.int32)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jt.loss_fn),
                                     static_argnums=3)(
        params, jx, jnp.asarray(labels), jcfg)
    loss = tt.loss_fn(model, tx, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, model.leaves())
    tol = DTYPES[dtype][2]
    assert_close(loss, want_loss, tol)
    for g, w in zip(grads, jax.tree_util.tree_leaves(want_grads)):
        assert g.dtype == model.cfg.dtype
        assert_close(g, w, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_images_to_tokens_is_exact(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(7)
    imgs = jnp.asarray(rng.standard_normal((3, 32, 48, 3)), jdt)
    want = np.asarray(jt.images_to_tokens(imgs, patch=16).astype(
        jnp.float32))
    got = tt.images_to_tokens(torch.from_numpy(np.asarray(
        imgs.astype(jnp.float32))).to(tdt), patch=16)
    assert got.shape == (3, 6, 768) and got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
