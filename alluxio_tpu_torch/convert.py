"""Carry the JAX package's state into the port.

- The device page store: the JAX ``HbmPageStore`` keeps each page as a
  uint8 array; taken through ``np.asarray`` they become
  ``{(file_id_hex, page_index): ndarray}``, which
  :func:`hbm_store_from_numpy` turns into a port ``HbmPageStore``
  holding the same pages on a torch device.
- The flagship model's train state: the JAX ``init_params`` tree and
  the ``optax.adamw`` state, taken to numpy leaf by leaf, become a port
  ``Transformer`` (:func:`transformer_params_from_numpy`) and its
  ``AdamState`` (:func:`opt_state_from_numpy`). A bf16 leaf may come as
  an ``ml_dtypes.bfloat16`` array or as its ``uint16`` view; either way
  its 16-bit words are reinterpreted, never converted through float.
  Under a mesh each rank takes its shards of the whole leaves.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Mapping, Tuple

import numpy as np
import torch

from alluxio_tpu_torch.client.cache.hbm_store import HbmPageStore
from alluxio_tpu_torch.client.cache.meta import PageId
from alluxio_tpu_torch.device import resolve_device
from alluxio_tpu_torch.parallel.mesh import shard
from alluxio_tpu_torch.utils.bf16 import numpy_to_tensor
from alluxio_tpu_torch.utils.pytree import tree_leaves

if TYPE_CHECKING:
    from alluxio_tpu_torch.models.train import AdamState
    from alluxio_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)


def _array_to_tensor(arr, dtype: torch.dtype) -> torch.Tensor:
    """A numpy leaf as a ``dtype`` CPU tensor; bf16 through its 16-bit
    words. Raises ``ValueError`` on any other dtype change."""
    arr = np.asarray(arr)
    bf16 = dtype == torch.bfloat16
    if bf16 and arr.dtype.name != "bfloat16" and arr.dtype != np.uint16:
        raise ValueError(f"a bf16 leaf must be bfloat16 or its uint16 "
                         f"view, not {arr.dtype}")
    t = numpy_to_tensor(arr, bf16=bf16)
    if t.dtype != dtype:
        raise ValueError(f"leaf dtype {t.dtype} != {dtype}")
    return t


def transformer_params_from_numpy(tree, cfg: TransformerConfig, *,
                                  mesh=None, device=None) -> Transformer:
    """A port ``Transformer`` for ``cfg`` on ``device`` (``None``: the
    card) holding the JAX ``init_params`` tree ``tree`` (numpy leaves);
    with ``mesh``, this rank's shards of it on the mesh's device."""
    from alluxio_tpu_torch.models.transformer import Transformer

    if mesh is None:
        device = resolve_device(device)
    model = Transformer(cfg, device=device, mesh=mesh)
    leaves = tree_leaves(tree)
    mine = model.leaves()
    if len(leaves) != len(mine):
        raise ValueError(f"tree has {len(leaves)} leaves; {cfg} has "
                         f"{len(mine)}")
    model.load_param_tree([
        _part(a, p, lay, mesh)
        for a, p, lay in zip(leaves, mine, model.layouts())])
    return model


def _part(arr, like: torch.Tensor, lay, mesh) -> torch.Tensor:
    """``arr`` as ``like``'s dtype on its device: whole, or this rank's
    shard under ``lay`` with ``mesh``."""
    t = _array_to_tensor(arr, like.dtype)
    if mesh is not None:
        t = shard(t, lay, mesh)
    return t.to(like.device)


def opt_state_from_numpy(tree, params, *, mesh=None,
                         shardings=None) -> AdamState:
    """The port's ``AdamState`` for ``params`` (a model's ``leaves()``)
    from an ``optax.adamw`` state with numpy leaves: ``(ScaleByAdamState
    (count, mu, nu), EmptyState(), EmptyState())``, or the
    ``ScaleByAdamState`` alone. Each moment takes the dtype and device
    of its parameter, as optax's do with ``mu_dtype=None``. With
    ``mesh``, ``shardings`` (``param_shardings(cfg)``) says how to take
    this rank's shard of each whole moment."""
    from alluxio_tpu_torch.models.train import AdamState

    params = tree_leaves(params)
    if mesh is not None and shardings is None:
        raise ValueError("a sharded state needs the parameters' shardings")
    layouts = tree_leaves(shardings) if mesh is not None \
        else [None] * len(params)
    adam = tree if hasattr(tree, "mu") else tree[0]

    def moments(sub):
        arrays = tree_leaves(sub)
        if len(arrays) != len(params):
            raise ValueError(f"state has {len(arrays)} moments; there are "
                             f"{len(params)} parameters")
        return [_part(a, p, lay, mesh)
                for a, p, lay in zip(arrays, params, layouts)]

    count = torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32,
                         device=params[0].device)
    return AdamState(count, moments(adam.mu), moments(adam.nu))


def hbm_store_from_numpy(pages: Mapping[Tuple[str, int], np.ndarray], *,
                         capacity_bytes: int, device=None) -> HbmPageStore:
    """A page store on ``device`` (``None``: the card) holding ``pages``.
    Raises ``ValueError`` if the pages do not fit in ``capacity_bytes``:
    a carried-over tier never drops a page silently."""
    total = sum(np.asarray(a).nbytes for a in pages.values())
    if total > capacity_bytes:
        raise ValueError(f"{total} bytes of pages exceed the store's "
                         f"capacity of {capacity_bytes}")
    store = HbmPageStore(capacity_bytes, device)
    for (file_id, index), arr in pages.items():
        host = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        store.put(PageId(file_id, int(index)), host)
    return store
