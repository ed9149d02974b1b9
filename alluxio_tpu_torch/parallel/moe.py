"""Top-1 mixture-of-experts FFN, on one card or expert-parallel: the
port of ``alluxio_tpu/parallel/moe.py``.

Dispatch is dense, through a one-hot combine, with the einsums of the
JAX package (capacity = tokens). ``params`` is any mapping with
``gate (d_model, E)``, ``w_in (E, d_model, d_ff)`` and
``w_out (E, d_ff, d_model)``.

Expert parallelism (:func:`moe_param_specs`): the experts are split
over the ``model`` axis, the gate is whole on every rank. Under a mesh
each rank routes every token with the whole gate, then dispatches, runs
and combines its own experts only; one sum over the axis joins the
combines. XLA derives the same collectives from the JAX shardings.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from alluxio_tpu_torch.device import resolve_device
from alluxio_tpu_torch.parallel.mesh import (MODEL_AXIS, REPLICATED, Layout,
                                             axis_rank, axis_size,
                                             group_mean, shard)
from alluxio_tpu_torch.parallel.tensor_parallel import (copy_to_group,
                                                        reduce_from_group)

EXPERT_AXIS = MODEL_AXIS  # experts ride the model axis (ep x tp fuse)


def init_moe_params(generator: torch.Generator, *, n_experts: int,
                    d_model: int, d_ff: int, dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """Normal init scaled by ``d_model**-0.5`` (gate, ``w_in``) and
    ``d_ff**-0.5`` (``w_out``), drawn on the generator's device and
    moved to ``device`` (``None``: the card)."""
    device = resolve_device(device)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator,
                        device=generator.device) * scale
        return x.to(device=device, dtype=dtype)

    return {
        "gate": normal((d_model, n_experts), d_model ** -0.5),
        "w_in": normal((n_experts, d_model, d_ff), d_model ** -0.5),
        "w_out": normal((n_experts, d_ff, d_model), d_ff ** -0.5),
    }


def moe_param_specs() -> Dict[str, Layout]:
    """The one source of the expert layout: experts split over
    :data:`EXPERT_AXIS` on their leading dim, the gate whole. The
    transformer's ``param_shardings`` takes it from here."""
    return {"gate": REPLICATED,
            "w_in": Layout(0, EXPERT_AXIS),
            "w_out": Layout(0, EXPERT_AXIS)}


def shard_moe_params(params, mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of whole ``params`` under :func:`moe_param_specs`
    (the counterpart of placing them on ``moe_param_shardings(mesh)``)."""
    return {name: shard(params[name], lay, mesh)
            for name, lay in moe_param_specs().items()}


def _route(params, x):
    logits = torch.einsum("btd,de->bte", x, params["gate"])
    top = torch.argmax(logits, dim=-1)
    onehot = F.one_hot(top, params["gate"].shape[-1]).to(x.dtype)
    return logits, top, onehot


def moe_ffn(params, x, *, mesh=None) -> torch.Tensor:
    """(B, T, d_model) -> (B, T, d_model), top-1 routed; the router's
    gradient flows through the softmax prob of the taken expert.

    Under ``mesh``, ``params`` holds this rank's experts (and the whole
    gate) and ``x`` is the same on every rank of the expert axis. Only
    the expert products' input is copied to the group: the gate path
    runs whole on every rank, so its gradient needs no sum."""
    logits, top, onehot = _route(params, x)
    gate = torch.gather(torch.softmax(logits, dim=-1), -1, top[..., None])
    x_e = x
    if mesh is not None:
        n_local = params["w_in"].shape[0]
        if n_local * axis_size(mesh, EXPERT_AXIS) != onehot.shape[-1]:
            raise ValueError(f"{n_local} local experts x "
                             f"{axis_size(mesh, EXPERT_AXIS)} ranks != the "
                             f"gate's {onehot.shape[-1]}")
        first = axis_rank(mesh, EXPERT_AXIS) * n_local
        onehot = onehot[..., first:first + n_local]
        x_e = copy_to_group(x, mesh.get_group(EXPERT_AXIS))
    dispatched = torch.einsum("btd,bte->ebtd", x_e, onehot)
    hidden = F.gelu(torch.einsum("ebtd,edf->ebtf", dispatched,
                                 params["w_in"]), approximate="tanh")
    expert_out = torch.einsum("ebtf,efd->ebtd", hidden, params["w_out"])
    combined = torch.einsum("ebtd,bte->btd", expert_out, onehot)
    if mesh is not None:
        combined = reduce_from_group(combined, mesh.get_group(EXPERT_AXIS))
    return combined * gate


def load_balance_loss(params, x, *, group=None) -> torch.Tensor:
    """Switch-style balance loss: mean routed fraction x mean router
    prob per expert, scaled by ``n_experts**2``. It needs only the gate,
    which every rank holds whole.

    ``group``: the data-parallel group whose ranks hold the rest of the
    batch (equal row counts). Both means are then taken over the whole
    batch, as JAX takes them over the global array: the routed fraction
    by an all-reduce, the router prob by an all-reduce of its value
    while its gradient stays this rank's, which the data-parallel mean
    of the gradients then sums over the group."""
    logits, _top, hard = _route(params, x)
    probs = torch.softmax(logits, dim=-1)
    n_experts = params["gate"].shape[-1]
    frac = hard.mean(dim=(0, 1))
    prob = probs.mean(dim=(0, 1))
    if group is not None:
        frac = group_mean(frac, group)
        prob = group_mean(prob, group) + (prob - prob.detach())
    return (frac * prob).sum() * n_experts * n_experts
