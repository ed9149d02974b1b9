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
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Mapping, Tuple

import numpy as np
import torch

from alluxio_tpu_torch.client.cache.hbm_store import HbmPageStore
from alluxio_tpu_torch.client.cache.meta import PageId
from alluxio_tpu_torch.device import resolve_device
from alluxio_tpu_torch.utils.bf16 import numpy_to_tensor
from alluxio_tpu_torch.utils.pytree import tree_leaves

if TYPE_CHECKING:
    from alluxio_tpu_torch.models.train import AdamState
    from alluxio_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)


def _array_to_tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy leaf as a ``dtype`` tensor on ``device``; bf16 through its
    16-bit words. Raises ``ValueError`` on any other dtype change."""
    arr = np.asarray(arr)
    bf16 = dtype == torch.bfloat16
    if bf16 and arr.dtype.name != "bfloat16" and arr.dtype != np.uint16:
        raise ValueError(f"a bf16 leaf must be bfloat16 or its uint16 "
                         f"view, not {arr.dtype}")
    t = numpy_to_tensor(arr, bf16=bf16)
    if t.dtype != dtype:
        raise ValueError(f"leaf dtype {t.dtype} != {dtype}")
    return t.to(device)


def transformer_params_from_numpy(tree, cfg: TransformerConfig, *,
                                  device=None) -> Transformer:
    """A port ``Transformer`` for ``cfg`` on ``device`` (``None``: the
    card) holding the JAX ``init_params`` tree ``tree`` (numpy leaves)."""
    from alluxio_tpu_torch.models.transformer import Transformer

    device = resolve_device(device)
    model = Transformer(cfg, device=device)
    leaves = tree_leaves(tree)
    mine = model.leaves()
    if len(leaves) != len(mine):
        raise ValueError(f"tree has {len(leaves)} leaves; {cfg} has "
                         f"{len(mine)}")
    model.load_param_tree([_array_to_tensor(a, p.dtype, device)
                           for a, p in zip(leaves, mine)])
    return model


def opt_state_from_numpy(tree, params) -> AdamState:
    """The port's ``AdamState`` for ``params`` (a model's ``leaves()``)
    from an ``optax.adamw`` state with numpy leaves: ``(ScaleByAdamState
    (count, mu, nu), EmptyState(), EmptyState())``, or the
    ``ScaleByAdamState`` alone. Each moment takes the dtype and device
    of its parameter, as optax's do with ``mu_dtype=None``."""
    from alluxio_tpu_torch.models.train import AdamState

    params = tree_leaves(params)
    adam = tree if hasattr(tree, "mu") else tree[0]

    def moments(sub):
        arrays = tree_leaves(sub)
        if len(arrays) != len(params):
            raise ValueError(f"state has {len(arrays)} moments; there are "
                             f"{len(params)} parameters")
        return [_array_to_tensor(a, p.dtype, p.device)
                for a, p in zip(arrays, params)]

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
