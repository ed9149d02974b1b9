"""Top-1 mixture-of-experts FFN on one card: the port of
``init_moe_params``, ``moe_ffn`` and ``load_balance_loss`` from
``alluxio_tpu/parallel/moe.py``.

Dispatch is dense, through a one-hot combine, with the einsums of the
JAX package (capacity = tokens). ``params`` is any mapping with
``gate (d_model, E)``, ``w_in (E, d_model, d_ff)`` and
``w_out (E, d_ff, d_model)``. The expert-parallel layout
(``moe_param_specs``/``moe_param_shardings``) waits for the mesh.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from alluxio_tpu_torch.device import resolve_device


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


def _route(params, x):
    logits = torch.einsum("btd,de->bte", x, params["gate"])
    top = torch.argmax(logits, dim=-1)
    onehot = F.one_hot(top, params["gate"].shape[-1]).to(x.dtype)
    return logits, top, onehot


def moe_ffn(params, x) -> torch.Tensor:
    """(B, T, d_model) -> (B, T, d_model), top-1 routed; the router's
    gradient flows through the softmax prob of the taken expert."""
    logits, top, onehot = _route(params, x)
    gate = torch.gather(torch.softmax(logits, dim=-1), -1, top[..., None])
    dispatched = torch.einsum("btd,bte->ebtd", x, onehot)
    hidden = F.gelu(torch.einsum("ebtd,edf->ebtf", dispatched,
                                 params["w_in"]), approximate="tanh")
    expert_out = torch.einsum("ebtf,efd->ebtd", hidden, params["w_out"])
    combined = torch.einsum("ebtd,bte->btd", expert_out, onehot)
    return combined * gate


def load_balance_loss(params, x) -> torch.Tensor:
    """Switch-style balance loss: mean routed fraction x mean router
    prob per expert, scaled by ``n_experts**2``."""
    logits, _top, hard = _route(params, x)
    probs = torch.softmax(logits, dim=-1)
    n_experts = params["gate"].shape[-1]
    frac = hard.mean(dim=(0, 1))
    prob = probs.mean(dim=(0, 1))
    return (frac * prob).sum() * n_experts * n_experts
