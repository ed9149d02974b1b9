"""The port's checkpoints against the JAX package's: the same layout
byte for byte, and a train state that either package writes restores
bit for bit in the other (exact: the leaves are raw bytes)."""

import functools

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from alluxio_tpu.models import checkpoint as jck  # noqa: E402
from alluxio_tpu.models import transformer as jt  # noqa: E402
from alluxio_tpu.utils.exceptions import FileDoesNotExistError  # noqa: E402
from alluxio_tpu_torch import convert  # noqa: E402
from alluxio_tpu_torch.models import checkpoint as tck  # noqa: E402
from alluxio_tpu_torch.models import train as ttrain  # noqa: E402
from alluxio_tpu_torch.models import transformer as tt  # noqa: E402
from alluxio_tpu_torch.utils import bf16  # noqa: E402
from alluxio_tpu_torch.utils.pytree import tree_leaves  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(vocab_or_patch_dim=48, d_model=32, n_heads=4, d_ff=64,
             n_layers=2, n_classes=10, max_len=16)


class MemFS:
    """The three calls the checkpoints use, over a dict."""

    def __init__(self, missing=FileNotFoundError):
        self.files = {}
        self._missing = missing

    def write_all(self, path, data, **_kw):
        self.files[path] = bytes(data)

    def read_all(self, path):
        return self.files[path]

    def list_status(self, base):
        names = {p[len(base) + 1:].split("/")[0] for p in self.files
                 if p.startswith(base + "/")}
        if not names:
            raise self._missing(base)
        return [type("Info", (), {"name": n})() for n in sorted(names)]


def raw(x):
    """(shape, bytes) of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.asarray(x)
    return x.shape, x.tobytes()


@functools.lru_cache(maxsize=None)  # JAX arrays are immutable
def jax_state(dtype, moe=0):
    """A JAX params tree and an ``optax.adamw`` state two steps in, so
    the moments and count are not their initial values."""
    jdt = DTYPES[dtype][0]
    cfg = jt.TransformerConfig(dtype=jdt, moe_experts=moe, **SMALL)
    params = jax.jit(jt.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(1))
    tx = optax.adamw(1e-3)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, grads):
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt

    rng = np.random.default_rng(5)
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape), p.dtype), params)
        params, opt = step(params, opt, grads)
    return params, opt


def port_state(params, opt, dtype, moe=0):
    cfg = tt.TransformerConfig(dtype=DTYPES[dtype][1], moe_experts=moe,
                               **SMALL)
    model = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, device="cpu")
    state = convert.opt_state_from_numpy(jax.tree.map(np.asarray, opt),
                                         model.leaves())
    return model, state


def fresh(dtype, moe=0):
    cfg = tt.TransformerConfig(dtype=DTYPES[dtype][1], moe_experts=moe,
                               **SMALL)
    model, state, _ = ttrain.make_train_state(cfg, device="cpu", seed=9)
    return model, state


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_same_files_byte_for_byte(dtype):
    params, opt = jax_state(dtype)
    model, state = port_state(params, opt, dtype)
    jfs, tfs = MemFS(), MemFS()
    jck.save_train_state(jfs, "/c", params, opt, step=2)
    tck.save_train_state(tfs, "/c", model.param_tree(), state, step=2)
    assert sorted(jfs.files) == sorted(tfs.files)
    for path, data in jfs.files.items():
        if path.endswith("tree.msgpack"):
            want = msgpack.unpackb(data, raw=False)
            got = msgpack.unpackb(tfs.files[path], raw=False)
            assert got["n_leaves"] == want["n_leaves"]
            assert got["metas"] == want["metas"]
        else:
            assert tfs.files[path] == data, path


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_jax_checkpoint_restores_in_the_port(dtype):
    params, opt = jax_state(dtype)
    fs = MemFS()
    jck.save_train_state(fs, "/ckpt/step-2", params, opt, step=2)
    model, state = fresh(dtype)
    got_p, got_o, step = tck.load_train_state(
        fs, "/ckpt/step-2", like_params=model.param_tree(), like_opt=state)
    assert step == 2
    assert isinstance(got_o, ttrain.AdamState)
    assert got_o.count.dtype == torch.int32 and int(got_o.count) == 2
    want = jax.tree_util.tree_leaves((params, opt))
    got = tree_leaves((got_p, got_o))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert raw(g) == raw(w)
    model.load_param_tree(got_p)
    for g, w in zip(model.leaves(), jax.tree_util.tree_leaves(params)):
        assert raw(g) == raw(w)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_checkpoint_restores_in_jax(dtype):
    params, opt = jax_state(dtype)
    model, state = port_state(params, opt, dtype)
    fs = MemFS()
    tck.save_train_state(fs, "/ckpt/step-2", model.param_tree(), state,
                         step=2)
    like_p, like_o = jax_state(dtype)
    like_p = jax.tree.map(jnp.zeros_like, like_p)
    got_p, got_o, step = jck.load_train_state(
        fs, "/ckpt/step-2", like_params=like_p, like_opt=like_o)
    assert step == 2
    for g, w in zip(jax.tree_util.tree_leaves((got_p, got_o)),
                    tree_leaves((model.param_tree(), state))):
        assert raw(g) == raw(w)


def test_moe_round_trip_in_the_port():
    params, opt = jax_state("float32", moe=4)
    model, state = port_state(params, opt, "float32", moe=4)
    fs = MemFS()
    n = tck.save_pytree(fs, "/p", model.param_tree())
    assert n == len(jax.tree_util.tree_leaves(params))
    like, _ = fresh("float32", moe=4)
    got = tck.load_pytree(fs, "/p", like=like.param_tree())
    for g, w in zip(tree_leaves(got), model.leaves()):
        assert raw(g) == raw(w)


def test_mismatches_raise():
    model, state = fresh("bfloat16")
    fs = MemFS()
    tck.save_pytree(fs, "/p", model.param_tree())
    other, _ = fresh("float32")
    with pytest.raises(ValueError, match="dtype"):
        tck.load_pytree(fs, "/p", like=other.param_tree())
    with pytest.raises(ValueError, match="leaves"):
        tck.load_pytree(fs, "/p", like=model.param_tree()["layers"])
    with pytest.raises(ValueError, match="like"):
        tck.load_pytree(fs, "/p", like=None)


@pytest.mark.parametrize("missing", [FileNotFoundError,
                                     FileDoesNotExistError])
def test_latest_step(missing):
    fs = MemFS(missing=missing)
    assert tck.latest_step(fs, "/ckpt") is None
    for n in (3, 12, 7):
        fs.write_all(f"/ckpt/step-{n}/STEP", b"x")
    fs.write_all("/ckpt/step-x/STEP", b"x")
    assert tck.latest_step(fs, "/ckpt") == 12

    class Broken(MemFS):
        def list_status(self, base):
            raise ConnectionError("transient")

    with pytest.raises(ConnectionError):
        tck.latest_step(Broken(), "/ckpt")


@pytest.mark.parametrize("shape", [(), (3,), (2, 5)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int32])
def test_leaf_words_round_trip(shape, dtype):
    """A leaf through its numpy words and back keeps its shape (0-d too),
    dtype and bits; bf16 travels as the words of ``ml_dtypes``."""
    t = (torch.arange(int(np.prod(shape)), dtype=torch.float32) - 1.5) \
        .reshape(shape).to(dtype)
    arr = bf16.tensor_to_numpy(t)
    is_bf16 = dtype == torch.bfloat16
    assert arr.shape == shape
    assert arr.dtype == (np.uint16 if is_bf16 else t.numpy().dtype)
    if is_bf16:
        want = np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
        assert arr.tobytes() == want.tobytes()
        assert torch.equal(bf16.bits(bf16.numpy_to_tensor(want, bf16=True)),
                           bf16.bits(t))
    back = bf16.numpy_to_tensor(arr, bf16=is_bf16)
    assert back.shape == t.shape and back.dtype == dtype
    assert torch.equal(bf16.bits(back), bf16.bits(t))
    with pytest.raises(ValueError, match="16-bit"):
        bf16.numpy_to_tensor(np.zeros(shape, np.float32), bf16=True)
