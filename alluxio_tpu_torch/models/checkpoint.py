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
``.name``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from alluxio_tpu_torch.utils.bf16 import numpy_to_tensor, tensor_to_numpy
from alluxio_tpu_torch.utils.pytree import tree_leaves, tree_unflatten


def _dtype_str(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def save_pytree(fs, path: str, tree) -> int:
    """Serialize a tree of tensors under ``path``; returns the leaf
    count."""
    import msgpack

    leaves = tree_leaves(tree)
    metas = []
    for i, leaf in enumerate(leaves):
        t = torch.as_tensor(leaf)
        arr = tensor_to_numpy(t)
        metas.append({"dtype": _dtype_str(t.dtype),
                      "shape": list(arr.shape)})
        fs.write_all(f"{path}/leaf-{i}.bin", arr.tobytes())
    blob = msgpack.packb({
        # informational only: both packages' loaders take the structure
        # from ``like``
        "treedef": f"alluxio_tpu_torch: {len(leaves)} leaves in "
                   f"jax.tree_util order",
        "n_leaves": len(leaves),
        "metas": metas,
    }, use_bin_type=True)
    fs.write_all(f"{path}/tree.msgpack", blob)
    return len(leaves)


def load_pytree(fs, path: str, *, like):
    """Restore a tree saved by :func:`save_pytree` (by either package).

    ``like`` is a tree of tensors with the same structure (e.g. a fresh
    model's ``param_tree()``): it gives the structure, and each restored
    leaf lands on the device of its ``like`` leaf. Shapes and dtypes
    must match exactly."""
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
    out = []
    for i, (m, ref) in enumerate(zip(meta["metas"], like_leaves)):
        if list(ref.shape) != m["shape"]:
            raise ValueError(
                f"leaf {i}: checkpoint shape {m['shape']} != model "
                f"shape {list(ref.shape)}")
        if _dtype_str(ref.dtype) != m["dtype"]:
            raise ValueError(
                f"leaf {i}: checkpoint dtype {m['dtype']} != model "
                f"dtype {_dtype_str(ref.dtype)}")
        bf16 = m["dtype"] == "bfloat16"
        arr = np.frombuffer(fs.read_all(f"{path}/leaf-{i}.bin"),
                            dtype=np.uint16 if bf16 else m["dtype"])
        out.append(numpy_to_tensor(arr.reshape(m["shape"]), bf16=bf16)
                   .to(ref.device))
    return tree_unflatten(like, out)


def save_train_state(fs, path: str, params, opt_state, *,
                     step: int) -> None:
    """Checkpoint (params, opt_state, step) under ``path``."""
    save_pytree(fs, f"{path}/params", params)
    save_pytree(fs, f"{path}/opt", opt_state)
    fs.write_all(f"{path}/STEP", str(step).encode())


def load_train_state(fs, path: str, *, like_params, like_opt):
    """Restore (params, opt_state, step) saved by save_train_state."""
    params = load_pytree(fs, f"{path}/params", like=like_params)
    opt = load_pytree(fs, f"{path}/opt", like=like_opt)
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
