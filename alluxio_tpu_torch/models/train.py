"""Training step for the flagship model, on one card or dp x tp.

The port of ``alluxio_tpu/models/train.py``: the forward and backward
are PyTorch autograd, the update is :func:`adamw`, which follows
``optax.adamw`` step for step (not ``torch.optim.AdamW``: torch decays
``p`` before the Adam step and defaults to weight decay 1e-2).

Under a mesh (:func:`make_sharded_train_state`) the batch is split over
``data`` and the parameters over ``model`` (``param_shardings``). Each
rank takes the mean loss of its rows; the gradients are summed over the
``data`` group and divided by its size, the gradient of the global-batch
mean that JAX's jit computes. AdamW runs on the local shards, so its
state is sharded like the parameters. The JAX step's sequence-parallel
option is not ported: it raises in the JAX package (ROADMAP).

Also here: :func:`sgd` (``optax.sgd``), for ``bench.py``'s linear-softmax
model.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, List, NamedTuple

import torch
import torch.distributed as dist

from alluxio_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  forward, loss_fn,
                                                  param_shardings)
from alluxio_tpu_torch.parallel.mesh import (DATA_AXIS, REPLICATED,
                                             group_mean)
from alluxio_tpu_torch.utils.pytree import tree_leaves
from alluxio_tpu_torch.utils.tracing import annotate

_INT32_MAX = 2**31 - 1


class AdamState(NamedTuple):
    """``optax.ScaleByAdamState``: an int32 count and the first and
    second moments, one per parameter in flatten order. Its leaves are
    those of ``optax.adamw``'s state (whose two ``EmptyState``s hold
    none), so checkpoints of the two restore into each other."""
    count: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_shardings(shardings) -> AdamState:
    """The layout tree of the AdamW state of parameters laid out by
    ``shardings``: the count whole, each moment as its parameter."""
    layouts = tree_leaves(shardings)
    return AdamState(REPLICATED, list(layouts), list(layouts))


def _as(x: float, dtype) -> float:
    """``x`` rounded to ``dtype``: JAX casts a Python scalar to the
    array's dtype (a weak type), so in bf16 ``0.999`` is ``1.0``."""
    return torch.tensor(x, dtype=dtype).item()


def _one_dtype(params) -> torch.dtype:
    dtypes = {p.dtype for p in params}
    if len(dtypes) != 1:
        raise ValueError(f"parameters of one dtype expected, got {dtypes}")
    return dtypes.pop()


@dataclasses.dataclass(frozen=True)
class _AdamW:
    """``optax.adamw(learning_rate)`` with optax's defaults (eps_root 0,
    ``mu_dtype`` None: the moments keep the parameters' dtype). Every
    step rounds where optax's does: each elementwise op in the
    parameters' dtype, the bias corrections in float32 and then cast."""
    learning_rate: float
    b1: ClassVar[float] = 0.9
    b2: ClassVar[float] = 0.999
    eps: ClassVar[float] = 1e-8
    weight_decay: ClassVar[float] = 1e-4

    def init(self, params) -> AdamState:
        params = list(params)
        return AdamState(
            count=torch.zeros((), dtype=torch.int32,
                              device=params[0].device),
            mu=[torch.zeros_like(p, memory_format=torch.contiguous_format)
                for p in params],
            nu=[torch.zeros_like(p, memory_format=torch.contiguous_format)
                for p in params])

    @torch.no_grad()
    def update(self, grads, state: AdamState, params) -> AdamState:
        """Apply one step to ``params`` in place; returns the new state."""
        params, grads = list(params), list(grads)
        dtype = _one_dtype(params)
        count = torch.where(state.count < _INT32_MAX, state.count + 1,
                            state.count)
        # float32 on the count's device: no host round trip per step
        t = count.float()
        bc1 = (1.0 - torch.pow(self.b1, t)).to(dtype)
        bc2 = (1.0 - torch.pow(self.b2, t)).to(dtype)
        mu = torch._foreach_mul(grads, _as(1 - self.b1, dtype))
        torch._foreach_add_(mu, torch._foreach_mul(state.mu,
                                                   _as(self.b1, dtype)))
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads),
                                _as(1 - self.b2, dtype))
        torch._foreach_add_(nu, torch._foreach_mul(state.nu,
                                                   _as(self.b2, dtype)))
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, _as(self.eps, dtype))
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_add_(u, torch._foreach_mul(
            params, _as(self.weight_decay, dtype)))
        torch._foreach_mul_(u, _as(-self.learning_rate, dtype))
        torch._foreach_add_(params, u)
        return AdamState(count, list(mu), list(nu))


@dataclasses.dataclass(frozen=True)
class _SGD:
    """``optax.sgd(learning_rate)`` without momentum: ``p += -lr * g``;
    no state."""
    learning_rate: float

    def init(self, params) -> tuple:
        return ()

    @torch.no_grad()
    def update(self, grads, state, params):
        params = list(params)
        u = torch._foreach_mul(list(grads),
                               _as(-self.learning_rate, _one_dtype(params)))
        torch._foreach_add_(params, u)
        return state


def adamw(learning_rate: float) -> _AdamW:
    return _AdamW(learning_rate)


def sgd(learning_rate: float) -> _SGD:
    return _SGD(learning_rate)


def make_train_state(cfg: TransformerConfig, *, device=None,
                     learning_rate: float = 1e-3, seed: int = 0):
    """(model, opt_state, tx) on ``device`` (``None``: the card)."""
    tx = adamw(learning_rate)
    model = Transformer(cfg, device=device, seed=seed)
    return model, tx.init(model.leaves()), tx


def make_sharded_train_state(cfg: TransformerConfig, mesh, *,
                             learning_rate: float = 1e-3, seed: int = 0):
    """(model, opt_state, tx, shardings): this rank's shards of the
    model drawn from ``seed`` (the same whole weights at any mesh shape),
    its AdamW state, and the layout tree ``param_shardings(cfg)``."""
    tx = adamw(learning_rate)
    model = Transformer(cfg, mesh=mesh, seed=seed)
    return model, tx.init(model.leaves()), tx, param_shardings(cfg)


def _check(model: Transformer, cfg: TransformerConfig, mesh) -> None:
    if model.cfg != cfg:
        raise ValueError("the model was built for another config")
    if model.mesh is not mesh:
        raise ValueError("the model was built for another mesh")


def _mean_grads(grads, group):
    """The gradients summed over ``group`` and divided by its size, in
    one all-reduce of the flattened gradients."""
    grads = list(grads)
    flat = group_mean(torch.cat([g.reshape(-1) for g in grads]), group)
    return [part.view_as(g) for part, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def make_train_step(cfg: TransformerConfig, tx, *, mesh=None):
    """``step(model, opt_state, tokens, labels) -> (model, opt_state,
    loss)``: loss and gradients, then ``tx``'s update in place. The three
    parts are named regions (``atpu.train.{forward,backward,update}``)
    on a ``torch.profiler`` timeline.

    With ``mesh``, ``tokens`` and ``labels`` are this rank's rows (its
    part of the batch over ``data``), and the loss returned is the mean
    over the whole batch."""
    def step(model: Transformer, opt_state, tokens, labels):
        _check(model, cfg, mesh)
        params = model.leaves()
        with annotate("atpu.train.forward"):
            loss = loss_fn(model, tokens, labels)
        with annotate("atpu.train.backward"):
            grads = torch.autograd.grad(loss, params)
            loss = loss.detach()
            if mesh is not None:
                data = mesh.get_group(DATA_AXIS)
                grads = _mean_grads(grads, data)
                loss = group_mean(loss, data)
        with annotate("atpu.train.update"):
            opt_state = tx.update(grads, opt_state, params)
        return model, opt_state, loss

    return step


def make_eval_step(cfg: TransformerConfig, *, mesh=None):
    """``step(model, tokens) -> logits`` without autograd; with ``mesh``,
    ``tokens`` are this rank's rows and the logits are the whole
    batch's, gathered over ``data`` in rank order."""
    @torch.no_grad()
    def step(model: Transformer, tokens):
        _check(model, cfg, mesh)
        logits = forward(model, tokens)
        if mesh is None:
            return logits
        group = mesh.get_group(DATA_AXIS)
        out = torch.empty((dist.get_world_size(group) * logits.shape[0],
                           *logits.shape[1:]), dtype=logits.dtype,
                          device=logits.device)
        dist.all_gather_into_tensor(out, logits.contiguous(), group=group)
        return out

    return step
