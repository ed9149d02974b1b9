"""Model checkpoints stored in the namespace.

The port of ``alluxio_tpu/models/checkpoint.py``, with the same layout
byte for byte, so a checkpoint that either package writes restores in
the other. Under ``<path>/``: ``tree.msgpack`` (``treedef``, a string
for people; ``n_leaves``; ``metas``, one ``{"dtype", "shape"}``
per leaf) and one ``leaf-<i>.bin`` per leaf of raw C-order bytes. Leaves
come in ``jax.tree_util`` order (``utils/pytree.py``). bf16 is written
and read as its raw 16-bit words under the dtype string ``"bfloat16"``.

``fs`` is duck-typed: ``write_all(path, data)``, ``read_all(path)``
and, for :func:`latest_step`, ``list_status(path)`` whose entries have a
``.name``. ``write_type`` (a ``client.streams.WriteType``: MUST_CACHE,
CACHE_THROUGH, THROUGH or ASYNC_THROUGH) is passed to every
``write_all`` when given, and the client's default is used when not.

Under a mesh the files hold the whole tree, in the same layout: on save
every sharded leaf is gathered over its mesh axis and global rank 0
writes; on load every rank reads the whole leaves and keeps its shards.
So a checkpoint from a dp x tp run restores on one card, or in the JAX
package, bit for bit, and the reverse.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from alluxio_tpu_torch.parallel.mesh import (REPLICATED, axis_size, gather,
                                             shard)
from alluxio_tpu_torch.utils.bf16 import numpy_to_tensor, tensor_to_numpy
from alluxio_tpu_torch.utils.pytree import tree_leaves, tree_unflatten


def _dtype_str(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def save_pytree(fs, path: str, tree, *, write_type=None) -> int:
    """Serialize a tree of tensors under ``path``; returns the leaf
    count."""
    import msgpack

    kwargs = {"write_type": write_type} if write_type else {}
    leaves = tree_leaves(tree)
    metas = []
    for i, leaf in enumerate(leaves):
        t = torch.as_tensor(leaf)
        arr = tensor_to_numpy(t)
        metas.append({"dtype": _dtype_str(t.dtype),
                      "shape": list(arr.shape)})
        fs.write_all(f"{path}/leaf-{i}.bin", arr.tobytes(), **kwargs)
    blob = msgpack.packb({
        # informational only: both packages' loaders take the structure
        # from ``like``
        "treedef": f"alluxio_tpu_torch: {len(leaves)} leaves in "
                   f"jax.tree_util order",
        "n_leaves": len(leaves),
        "metas": metas,
    }, use_bin_type=True)
    fs.write_all(f"{path}/tree.msgpack", blob, **kwargs)
    return len(leaves)


def gather_tree(tree, shardings, mesh):
    """The whole tree from this rank's shards: each leaf that
    ``shardings`` (a tree of layouts of the same structure) splits over
    a mesh axis is all-gathered over it. A collective: every rank
    calls it."""
    leaves = tree_leaves(tree)
    layouts = _layouts(shardings, len(leaves))
    return tree_unflatten(tree, [gather(t, lay, mesh)
                                 for t, lay in zip(leaves, layouts)])


def gather_param_tree(model):
    """``model.param_tree()`` with whole tensors (gathered over the
    mesh when the model holds shards)."""
    from alluxio_tpu_torch.models.transformer import param_shardings

    if model.mesh is None:
        return model.param_tree()
    return gather_tree(model.param_tree(), param_shardings(model.cfg),
                       model.mesh)


def gather_opt_state(opt_state, model):
    """``opt_state`` (the AdamW state of ``model``'s leaves) with whole
    moments."""
    from alluxio_tpu_torch.models.train import adam_shardings
    from alluxio_tpu_torch.models.transformer import param_shardings

    if model.mesh is None:
        return opt_state
    return gather_tree(opt_state, adam_shardings(param_shardings(model.cfg)),
                       model.mesh)


def _layouts(shardings, n: int):
    if shardings is None:
        raise ValueError("a tree of shards needs its shardings")
    layouts = tree_leaves(shardings)
    if len(layouts) != n:
        raise ValueError(f"shardings tree has {len(layouts)} leaves; the "
                         f"tree has {n}")
    return layouts


def load_pytree(fs, path: str, *, like, mesh=None, shardings=None):
    """Restore a tree saved by :func:`save_pytree` (by either package).

    ``like`` is a tree of tensors with the same structure (e.g. a fresh
    model's ``param_tree()``): it gives the structure, and each restored
    leaf lands on the device of its ``like`` leaf. Shapes and dtypes
    must match exactly. With ``mesh``, ``like`` holds this rank's shards
    laid out by ``shardings``: each whole leaf is read, checked against
    the whole shape, and sliced."""
    import msgpack

    if like is None:
        raise ValueError("load_pytree needs `like=` (a structure-matched "
                         "tree, e.g. a fresh model's param_tree())")
    meta = msgpack.unpackb(fs.read_all(f"{path}/tree.msgpack"), raw=False)
    like_leaves = tree_leaves(like)
    if meta["n_leaves"] != len(like_leaves):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves; `like` has "
            f"{len(like_leaves)} — structure mismatch")
    layouts = _layouts(shardings, len(like_leaves)) if mesh is not None \
        else [REPLICATED] * len(like_leaves)
    out = []
    for i, (m, ref, lay) in enumerate(zip(meta["metas"], like_leaves,
                                          layouts)):
        whole = list(ref.shape)
        if lay.dim is not None:
            whole[lay.dim] *= axis_size(mesh, lay.axis)
        if whole != m["shape"]:
            raise ValueError(
                f"leaf {i}: checkpoint shape {m['shape']} != model "
                f"shape {whole}")
        if _dtype_str(ref.dtype) != m["dtype"]:
            raise ValueError(
                f"leaf {i}: checkpoint dtype {m['dtype']} != model "
                f"dtype {_dtype_str(ref.dtype)}")
        bf16 = m["dtype"] == "bfloat16"
        arr = np.frombuffer(fs.read_all(f"{path}/leaf-{i}.bin"),
                            dtype=np.uint16 if bf16 else m["dtype"])
        t = numpy_to_tensor(arr.reshape(m["shape"]), bf16=bf16)
        if mesh is not None:
            t = shard(t, lay, mesh)
        out.append(t.to(ref.device))
    return tree_unflatten(like, out)


def save_train_state(fs, path: str, params, opt_state, *, step: int,
                     write_type=None, mesh=None, param_shardings=None,
                     opt_shardings=None) -> None:
    """Checkpoint (params, opt_state, step) under ``path``. With
    ``mesh``, ``params`` and ``opt_state`` are this rank's shards laid
    out by ``param_shardings``/``opt_shardings``; every
    rank calls it, the whole trees are gathered, global rank 0 writes,
    and all return once the files are written."""
    import torch.distributed as dist

    if mesh is not None:
        params = gather_tree(params, param_shardings, mesh)
        opt_state = gather_tree(opt_state, opt_shardings, mesh)
        if dist.get_rank() != 0:
            dist.barrier()
            return
    kwargs = {"write_type": write_type} if write_type else {}
    save_pytree(fs, f"{path}/params", params, write_type=write_type)
    save_pytree(fs, f"{path}/opt", opt_state, write_type=write_type)
    fs.write_all(f"{path}/STEP", str(step).encode(), **kwargs)
    if mesh is not None:
        dist.barrier()


def load_train_state(fs, path: str, *, like_params, like_opt, mesh=None,
                     param_shardings=None, opt_shardings=None):
    """Restore (params, opt_state, step) saved by save_train_state; with
    ``mesh``, this rank's shards of them (``like_params``/``like_opt``
    hold shards laid out by ``param_shardings``/``opt_shardings``)."""
    params = load_pytree(fs, f"{path}/params", like=like_params, mesh=mesh,
                         shardings=param_shardings)
    opt = load_pytree(fs, f"{path}/opt", like=like_opt, mesh=mesh,
                      shardings=opt_shardings)
    step = int(fs.read_all(f"{path}/STEP").decode())
    return params, opt, step


def _is_missing(exc: BaseException) -> bool:
    # the cluster client raises its own FileDoesNotExistError, which the
    # port cannot import: match it by name
    return isinstance(exc, FileNotFoundError) or any(
        c.__name__ == "FileDoesNotExistError" for c in type(exc).__mro__)


def latest_step(fs, base: str) -> Optional[int]:
    """Highest ``step-<n>`` child under ``base`` (checkpoint dirs written
    as ``{base}/step-{n}``), or None."""
    try:
        infos = fs.list_status(base)
    except Exception as e:  # noqa: BLE001 re-raised unless "not found"
        if _is_missing(e):
            return None  # no checkpoints yet; any other error RAISES —
            # "cannot list" must not read as "resume from scratch"
        raise
    steps = []
    for i in infos:
        name = i.name
        if name.startswith("step-"):
            try:
                steps.append(int(name[len("step-"):]))
            except ValueError:
                continue
    return max(steps) if steps else None
