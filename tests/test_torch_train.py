"""The port's optimizers and train steps against ``optax`` and the JAX
package's train step on the CPU.

Tolerances. The optimizer alone, fed the same gradients: float32 to
1e-6 relative; bf16 to 1 ulp (2**-8 relative), since the port rounds
after every op where optax does, while XLA may keep a fused chain in
float32. Three full train steps of the small model: the losses to
1e-5 (float32) and 2**-5 (bf16) relative, the forward and backward
tolerance of ``test_torch_transformer.py``, since the gradients that
drive the steps already differ by that much. The parameters after them
are held per tensor, by the norm of the difference against the norm of
the tensor, to the same tolerance. Per element they are held only to
Adam's step bound (2 x lr per step): Adam divides each gradient by its
own running RMS, so where a gradient is near zero a rounding difference
can turn that element's step around.
"""

import importlib.util
from pathlib import Path

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from alluxio_tpu.models import train as jtrain  # noqa: E402
from alluxio_tpu.models import transformer as jt  # noqa: E402
from alluxio_tpu.parallel.mesh import make_mesh  # noqa: E402
from alluxio_tpu_torch import convert  # noqa: E402
from alluxio_tpu_torch.models import train as ttrain  # noqa: E402
from alluxio_tpu_torch.models import transformer as tt  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(vocab_or_patch_dim=48, d_model=32, n_heads=4, d_ff=64,
             n_layers=2, n_classes=10, max_len=16)


def chip_smoke():
    """The port's bench script, which holds the linear-softmax model."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_t(a, tdt):
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(
        jnp.float32))).to(tdt)


def to_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_adamw_three_steps_match_optax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(10)
    shapes = {"a": (7, 5), "b": {"c": (3,), "d": (2, 4, 3)}}
    params = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s), jdt), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    tx = optax.adamw(3e-2)
    opt = tx.init(params)
    mine = [to_t(a, tdt) for a in jax.tree_util.tree_leaves(params)]
    ttx = ttrain.adamw(3e-2)
    assert ttx.weight_decay == 1e-4  # optax's default, not torch's 1e-2
    state = ttx.init(mine)
    for _ in range(3):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), jdt),
            params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        state = ttx.update([to_t(g, tdt) for g in
                            jax.tree_util.tree_leaves(grads)], state, mine)
    assert state.count.dtype == torch.int32 and int(state.count) == 3
    assert int(opt[0].count) == 3
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    want = jax.tree_util.tree_leaves(
        (params, opt[0].mu, opt[0].nu))
    for got, w in zip(mine + state.mu + state.nu, want):
        assert got.dtype == tdt
        np.testing.assert_allclose(to_np(got), to_np(w), rtol=tol,
                                   atol=1e-12)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sgd_update_matches_optax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    p = {"w": jnp.asarray(rng.standard_normal((6, 4)), jdt),
         "b": jnp.asarray(rng.standard_normal(4), jdt)}
    g = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jdt), p)
    tx = optax.sgd(1e-1)
    updates, _ = tx.update(g, tx.init(p), p)
    want = optax.apply_updates(p, updates)
    mine = [to_t(a, tdt) for a in jax.tree_util.tree_leaves(p)]
    ttx = ttrain.sgd(1e-1)
    assert ttx.update([to_t(a, tdt) for a in jax.tree_util.tree_leaves(g)],
                      ttx.init(mine), mine) == ()
    for got, w in zip(mine, jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(to_np(got), to_np(w))


def test_linear_sgd_step_matches_bench():
    """``bench.py``'s linear-softmax SGD step, on decoded-like bf16
    images, float32 params (tolerance 1e-5: float32 summation order)."""
    rng = np.random.default_rng(12)
    n_classes, b = 10, 8
    imgs = jnp.asarray(rng.standard_normal((b, 4, 4, 3)), jnp.bfloat16)
    labels = rng.integers(0, n_classes, b).astype(np.int32)
    w0 = (rng.standard_normal((48, n_classes)) * 0.01).astype(np.float32)
    params = {"w": jnp.asarray(w0), "b": jnp.zeros(n_classes, jnp.float32)}
    tx = optax.sgd(1e-3)

    def loss_fn(p, imgs, labels):  # bench.py:776-781
        x = imgs.reshape(imgs.shape[0], -1).astype(jnp.float32)
        logits = x @ p["w"] + p["b"]
        onehot = jax.nn.one_hot(labels, n_classes)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot,
                                 axis=-1))

    opt = tx.init(params)
    mine = {"w": torch.from_numpy(w0.copy()).requires_grad_(),
            "b": torch.zeros(n_classes).requires_grad_()}
    step = chip_smoke().make_linear_train_step(ttrain.sgd(1e-3))
    state = ()
    for _ in range(2):
        loss, grads = jax.value_and_grad(loss_fn)(params, imgs,
                                                  jnp.asarray(labels))
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        mine, state, tloss = step(mine, state, to_t(imgs, torch.bfloat16),
                                  torch.from_numpy(labels))
        np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(to_np(mine[k]), to_np(params[k]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_three_train_steps_match_the_jax_step(dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg = jt.TransformerConfig(dtype=jdt, **SMALL)
    tcfg = tt.TransformerConfig(dtype=tdt, **SMALL)
    mesh = make_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    lr = 1e-3  # both packages' default
    params, opt, tx, shardings = jtrain.make_sharded_train_state(
        jcfg, mesh, learning_rate=lr)
    jstep = jtrain.make_train_step(jcfg, mesh, tx, shardings)
    model = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, device="cpu")
    state = convert.opt_state_from_numpy(jax.tree.map(np.asarray, opt),
                                         model.leaves())
    ttx = ttrain.adamw(lr)
    tstep = ttrain.make_train_step(tcfg, ttx)
    rng = np.random.default_rng(13)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    for _ in range(3):
        x = rng.standard_normal((4, 16, 48)).astype(np.float32)
        y = rng.integers(0, 10, 4).astype(np.int32)
        params, opt, jloss = jstep(params, opt, jnp.asarray(x, jdt),
                                   jnp.asarray(y))
        model, state, loss = tstep(model, state, to_t(x, tdt),
                                   torch.from_numpy(y))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=tol)
    for got, want in zip(model.leaves(), jax.tree_util.tree_leaves(params)):
        want = to_np(want)
        diff = to_np(got) - want
        assert np.linalg.norm(diff) <= tol * np.linalg.norm(want)
        assert np.abs(diff).max() <= 2 * lr * 3
    logits = ttrain.make_eval_step(tcfg)(model, to_t(x, tdt))
    assert logits.shape == (4, 10) and not logits.requires_grad
    with pytest.raises(ValueError):
        ttrain.make_train_step(tt.TransformerConfig(), ttx)(
            model, state, to_t(x, tdt), torch.from_numpy(y))


def test_make_train_state_defaults():
    cfg = tt.TransformerConfig(**SMALL)
    model, state, tx = ttrain.make_train_state(cfg, device="cpu", seed=3)
    assert model.embed.dtype == torch.bfloat16
    assert tx.learning_rate == 1e-3 and tx.weight_decay == 1e-4
    assert int(state.count) == 0 and len(state.mu) == len(model.leaves())
    again, _, _ = ttrain.make_train_state(cfg, device="cpu", seed=3)
    for a, b in zip(model.leaves(), again.leaves()):
        assert torch.equal(a, b)
