"""The port's dp x tp train step on a ``{"data": 2, "model": 2}`` gloo
mesh against the JAX package's ``make_train_step`` on the same mesh
shape of fake CPU devices, and its sharded checkpoints against both
packages' whole ones.

One module-scoped fixture takes the JAX initial state of each variant
(dense and MoE, float32 and bf16) to numpy, spawns a group of 4 ranks
(``tests/testutils/torch_dist.py``) that run 3 steps from it on their
shards, and runs the JAX steps on the same batches. Tolerances, as in
``tests/test_torch_train.py``: the losses to 1e-5 (float32) and 2**-5
(bf16) relative; the parameters after the steps per tensor, the norm
of the difference within the same fraction of the tensor's norm, and
per element within Adam's step bound (2 x lr a step); the eval logits
like the losses, against their largest magnitude. The bf16 MoE is held
by its checkpoints only: in bf16 a near-tie in the router's argmax can
send a token to another expert in either package, as
``tests/test_torch_transformer.py`` notes. Checkpoints are exact: a
2 x 2 run's restores bit for bit in JAX and on one card, and theirs
restore into the 2 x 2 shards bit for bit. The workers import only
torch, numpy and the port.
"""

import pickle
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from alluxio_tpu_torch import convert  # noqa: E402
from alluxio_tpu_torch.models import checkpoint as tck  # noqa: E402
from alluxio_tpu_torch.models import train as ttrain  # noqa: E402
from alluxio_tpu_torch.models import transformer as tt  # noqa: E402
from alluxio_tpu_torch.parallel.mesh import (REPLICATED,  # noqa: E402
                                             make_mesh, shard_host_batch)
from alluxio_tpu_torch.utils.bf16 import (numpy_to_tensor,  # noqa: E402
                                          tensor_to_numpy)
from alluxio_tpu_torch.utils.pytree import tree_leaves  # noqa: E402
from tests.testutils.torch_dist import run_groups  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

SMALL = dict(vocab_or_patch_dim=48, d_model=32, n_heads=4, d_ff=64,
             n_layers=2, n_classes=10, max_len=16)
VARIANTS = {"dense-float32": (0, "float32"), "dense-bfloat16": (0, "bfloat16"),
            "moe-float32": (4, "float32"), "moe-bfloat16": (4, "bfloat16")}
#: the variants whose steps are held against JAX's
STEPPED = ("dense-float32", "dense-bfloat16", "moe-float32")
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LR = 1e-3
STEPS = 3
BATCH = 4
SEED = 5  # make_sharded_train_state's, against the single-card model


def tcfg(variant):
    experts, dtype = VARIANTS[variant]
    return tt.TransformerConfig(dtype=TORCH_DTYPES[dtype],
                                moe_experts=experts, **SMALL)


def batches():
    rng = np.random.default_rng(40)
    return [(rng.standard_normal((BATCH, 16, 48)).astype(np.float32),
             rng.integers(0, 10, BATCH).astype(np.int32))
            for _ in range(STEPS)]


class DirFS:
    """The calls the checkpoints make, on files under a directory that
    every rank and the parent share."""

    def __init__(self, root):
        self.root = Path(root)

    def write_all(self, path, data, **_kw):
        p = self.root / path.lstrip("/")
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(bytes(data))

    def read_all(self, path):
        return (self.root / path.lstrip("/")).read_bytes()


def host(t):
    """A tensor's values on the host; bf16 as its 16-bit words."""
    return tensor_to_numpy(t)


def train(rank, world, out_dir):
    """3 dp x tp steps of every variant from the JAX initial state; then
    each variant's checkpoint, and the restores of the whole ones."""
    inputs = pickle.loads((Path(out_dir) / "inputs.pkl").read_bytes())
    mesh = make_mesh({"data": 2, "model": 2}, device_type="cpu")
    fs = DirFS(Path(out_dir) / "ckpt")
    out = {"coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model"))}
    for variant, init in inputs["init"].items():
        cfg = tcfg(variant)
        shardings = tt.param_shardings(cfg)
        model = convert.transformer_params_from_numpy(init["params"], cfg,
                                                      mesh=mesh)
        opt = convert.opt_state_from_numpy(
            SimpleNamespace(**init["opt"]), model.leaves(), mesh=mesh,
            shardings=shardings)
        tx = ttrain.adamw(LR)
        step = ttrain.make_train_step(cfg, tx, mesh=mesh)
        losses = []
        for x, y in batches():
            xl = shard_host_batch(mesh, x).to(cfg.dtype)
            model, opt, loss = step(model, opt, xl,
                                    shard_host_batch(mesh, y))
            losses.append(float(loss))
        logits = ttrain.make_eval_step(cfg, mesh=mesh)(model, xl)
        tck.save_train_state(fs, f"/{variant}", model.param_tree(), opt,
                             step=STEPS, mesh=mesh, param_shardings=shardings,
                             opt_shardings=ttrain.adam_shardings(shardings))
        out[variant] = {
            "losses": losses, "logits": logits.numpy(),
            "params": [host(t) for t in
                       tree_leaves(tck.gather_param_tree(model))],
            "opt": [host(t) for t in
                    tree_leaves(tck.gather_opt_state(opt, model))],
            "restored": {name: restore(fs, f"/{name}", cfg, mesh)
                         for name in inputs["saved"].get(variant, ())}}
    cfg = tcfg("moe-bfloat16")
    model, opt, tx, shardings = ttrain.make_sharded_train_state(
        cfg, mesh, learning_rate=LR, seed=SEED)
    assert tx.learning_rate == LR and int(opt.count) == 0
    assert shardings == tt.param_shardings(cfg)
    out["seeded"] = [host(t) for t in
                     tree_leaves(tck.gather_param_tree(model))]
    out["local_shapes"] = [tuple(t.shape) for t in model.leaves()]
    return out


def restore(fs, path, cfg, mesh):
    """This rank's shards of a whole checkpoint."""
    shardings = tt.param_shardings(cfg)
    fresh = tt.Transformer(cfg, mesh=mesh, seed=9)
    params, opt, step = tck.load_train_state(
        fs, path, like_params=fresh.param_tree(),
        like_opt=ttrain.adamw(LR).init(fresh.leaves()), mesh=mesh,
        param_shardings=shardings,
        opt_shardings=ttrain.adam_shardings(shardings))
    return {"step": step, "leaves": [host(t) for t in
                                     tree_leaves((params, opt))]}


# -- the JAX side -------------------------------------------------------------
def _j():
    import jax
    import jax.numpy as jnp

    from alluxio_tpu.models import checkpoint as jck
    from alluxio_tpu.models import train as jtrain
    from alluxio_tpu.models import transformer as jt
    from alluxio_tpu.parallel.mesh import make_mesh as jax_mesh
    return SimpleNamespace(jax=jax, jnp=jnp, ck=jck, train=jtrain, t=jt,
                           mesh=jax_mesh({"data": 2, "model": 2},
                                         devices=jax.devices()[:4]))


def _words(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _jcfg(j, variant):
    experts, dtype = VARIANTS[variant]
    return j.t.TransformerConfig(dtype=getattr(j.jnp, dtype),
                                 moe_experts=experts, **SMALL)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's 2 x 2 results, the JAX results of the same steps, and
    the whole states the checkpoints came from."""
    j = _j()
    out_dir = tmp_path_factory.mktemp("sharded_train")
    init, jax_states, like = {}, {}, {}
    fs = DirFS(out_dir / "ckpt")
    for variant in VARIANTS:
        cfg = _jcfg(j, variant)
        params, opt, tx, shardings = j.train.make_sharded_train_state(
            cfg, j.mesh, learning_rate=LR)
        leaves = j.jax.tree_util.tree_leaves
        init[variant] = {
            "params": [_words(a) for a in leaves(params)],
            "opt": {"count": int(opt[0].count),
                    "mu": [_words(a) for a in leaves(opt[0].mu)],
                    "nu": [_words(a) for a in leaves(opt[0].nu)]}}
        jax_states[variant] = (params, opt, tx, shardings)
        like[variant] = (j.jax.tree.map(np.asarray, params),
                         j.jax.tree.map(np.asarray, opt))
    # whole checkpoints for the 2 x 2 run to restore: the JAX initial
    # state, and a single-card port state at another seed
    j.ck.save_train_state(fs, "/jax-init", *jax_states["dense-bfloat16"][:2],
                          step=0)
    one, one_opt, _ = ttrain.make_train_state(tcfg("moe-float32"),
                                              device="cpu", seed=11)
    one_opt = ttrain.adamw(LR).update(
        [torch.full_like(p, 0.5) for p in one.leaves()], one_opt,
        one.leaves())
    tck.save_train_state(fs, "/port-one", one.param_tree(), one_opt, step=1)
    saved = {"dense-bfloat16": ("jax-init",), "moe-float32": ("port-one",)}
    (out_dir / "inputs.pkl").write_bytes(pickle.dumps(
        {"init": init, "saved": saved}))
    port = run_groups(__name__, {"w4": (4, "train")}, out_dir)["w4"]
    # the same steps in JAX
    results = {}
    for variant in STEPPED:
        params, opt, tx, shardings = jax_states[variant]
        cfg = _jcfg(j, variant)
        step = j.train.make_train_step(cfg, j.mesh, tx, shardings)
        losses = []
        for x, y in batches():
            xj = j.jnp.asarray(x, cfg.dtype)
            params, opt, loss = step(params, opt, xj, j.jnp.asarray(y))
            losses.append(float(loss))
        logits = j.train.make_eval_step(cfg, j.mesh, shardings)(params, xj)
        results[variant] = {"losses": losses, "params": params,
                            "logits": np.asarray(logits)}
    return SimpleNamespace(j=j, port=port, jax=results, fs=fs, init=init,
                           like=like, one=(one, one_opt))


def _f32(a, dtype):
    if dtype == "bfloat16":
        return numpy_to_tensor(a, bf16=True).float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("variant", STEPPED)
def test_three_dp_tp_steps_match_the_jax_step(run, variant):
    dtype = VARIANTS[variant][1]
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    want = run.jax[variant]
    ranks = [r[variant] for r in run.port]
    for r in ranks:  # every rank returns the whole batch's loss
        assert r["losses"] == ranks[0]["losses"]
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=tol)
    jleaves = run.j.jax.tree_util.tree_leaves(want["params"])
    for r in ranks:  # the gathered shards: the same on every rank
        for got, w in zip(r["params"], ranks[0]["params"]):
            np.testing.assert_array_equal(got, w)
    assert len(ranks[0]["params"]) == len(jleaves)
    for got, w in zip(ranks[0]["params"], jleaves):
        got, w = _f32(got, dtype), _f32(_words(w), dtype)
        assert got.shape == w.shape
        diff = got - w
        assert np.linalg.norm(diff) <= tol * np.linalg.norm(w)
        assert np.abs(diff).max() <= 2 * LR * STEPS
    scale = np.abs(want["logits"]).max()
    for r in ranks:
        assert r["logits"].shape == want["logits"].shape
        assert np.abs(r["logits"] - want["logits"]).max() <= tol * scale


def test_the_seed_gives_the_single_card_weights(run):
    whole = tt.Transformer(tcfg("moe-bfloat16"), device="cpu", seed=SEED)
    want = [host(t) for t in whole.leaves()]
    for r in run.port:
        assert len(r["seeded"]) == len(want)
        for got, w in zip(r["seeded"], want):
            np.testing.assert_array_equal(got, w)
    # shards, not copies: wqkv is split over model on dim 2
    shapes = run.port[0]["local_shapes"]
    assert (32, 3, 2, 8) in shapes and (2, 32, 64) in shapes


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_a_2x2_checkpoint_restores_in_jax_and_on_one_card(run, variant):
    j, fs = run.j, run.fs
    params0, opt0 = run.like[variant]
    jparams, jopt, step = j.ck.load_train_state(
        fs, f"/{variant}", like_params=params0, like_opt=opt0)
    assert step == STEPS
    saved = run.port[0][variant]
    jl = [_words(a) for a in j.jax.tree_util.tree_leaves((jparams, jopt))]
    assert len(jl) == len(saved["params"]) + len(saved["opt"])
    for got, w in zip(jl, saved["params"] + saved["opt"]):
        np.testing.assert_array_equal(got, w)
    one = tt.Transformer(tcfg(variant), device="cpu", seed=3)
    params, opt, step = tck.load_train_state(
        fs, f"/{variant}", like_params=one.param_tree(),
        like_opt=ttrain.adamw(LR).init(one.leaves()))
    assert step == STEPS
    for got, w in zip(tree_leaves((params, opt)),
                      saved["params"] + saved["opt"]):
        np.testing.assert_array_equal(host(got), w)


def _slice(arr, lay, coords):
    if lay.dim is None:
        return arr
    n = arr.shape[lay.dim] // 2
    r = coords[0] if lay.axis == "data" else coords[1]
    return np.take(arr, range(r * n, (r + 1) * n), axis=lay.dim)


@pytest.mark.parametrize("variant,name", [("dense-bfloat16", "jax-init"),
                                          ("moe-float32", "port-one")])
def test_whole_checkpoints_restore_into_the_2x2_shards(run, variant, name):
    cfg = tcfg(variant)
    if name == "jax-init":
        init = run.init[variant]
        whole = init["params"] + [np.asarray(init["opt"]["count"],
                                             np.int32)] \
            + init["opt"]["mu"] + init["opt"]["nu"]
    else:
        one, one_opt = run.one
        whole = [host(t) for t in tree_leaves((one.param_tree(), one_opt))]
    lays = tree_leaves(tt.param_shardings(cfg))
    lays = lays + [REPLICATED] + lays + lays
    for r in run.port:
        got = r[variant]["restored"][name]
        assert got["step"] == (0 if name == "jax-init" else 1)
        assert len(got["leaves"]) == len(whole)
        for g, w, lay in zip(got["leaves"], whole, lays):
            np.testing.assert_array_equal(g, _slice(np.asarray(w), lay,
                                                    r["coords"]))

