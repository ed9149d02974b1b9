"""Flagship consumer model: the compact ViT-style transformer, on one card.

The port of ``alluxio_tpu/models/transformer.py``. The parameters are
plain ``nn.Parameter``s with the JAX tree's names and shapes, so a JAX
parameter tree maps onto them one to one (``convert.py``) and
:meth:`Transformer.param_tree` flattens in the JAX order (checkpoints):

- ``embed (P, d)``, ``pos (max_len, d)``, ``head (d, C)``,
  ``final_ln.scale (d,)``;
- per layer ``ln1.scale``, ``wqkv (d, 3, h, k)``, ``wo (h, k, d)``,
  ``ln2.scale``, then ``w1 (d, f)``/``w2 (f, d)``, or
  ``moe.{gate,w_in,w_out}`` when ``moe_experts > 0``.

The forward mirrors the JAX one's dtype steps: tokens are cast to
``cfg.dtype`` before the embed product, ``x + pos`` stays in that dtype,
RMS norm takes its variance in float32 and casts back before the scale,
attention runs in float32 inside, GELU is the tanh form, and the logits
are cast to float32.

Under a mesh (``Transformer(cfg, mesh=...)``) each rank holds its shards
of the parameters as :func:`param_shardings` lays them out: attention
split by heads over ``model`` (``wqkv`` on dim 2, ``wo`` on dim 0), the
dense FFN by ``w1`` columns and ``w2`` rows, the MoE by experts, the
rest whole. Each split product takes its input through
``copy_to_group`` and sums its partial output with
``reduce_from_group``. The batch is split over ``data``: each rank runs
its own rows, and the MoE balance loss takes its means over the whole
batch.

Sequence parallelism (``seq_axis``, as in the JAX package): ``tokens``
is this rank's T-shard, and attention is :func:`ring_attention_local`
over the axis's group, not causal. The forward is what the JAX one
computes per shard inside a ``shard_map``, three oddities included,
which are the reference's and are kept:

- positions are ``pos[:t_local]`` on every shard, so each shard's
  positions start again at 0 (``alluxio_tpu/models/transformer.py:143-144``);
- ``pooled`` is the mean over this rank's shard only (``:157``), so the
  logits and the loss are the shard's own;
- the MoE balance loss is this shard's: JAX's ``load_balance_loss``
  (``alluxio_tpu/parallel/moe.py:89``) has no collective, so no group
  takes its means.

The gradients of a shard's loss are those of JAX's ``value_and_grad``
inside the ``shard_map``: the ring's backward brings each rank the dk
and dv of its block from every rank's loss. The JAX train step's
``seq_parallel`` raises ``NameError`` (ROADMAP), so the port's train
step has no such option.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from alluxio_tpu_torch.device import resolve_device
from alluxio_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                             REPLICATED, Layout, mesh_device,
                                             shard)
from alluxio_tpu_torch.parallel.moe import (init_moe_params,
                                            load_balance_loss, moe_ffn,
                                            moe_param_specs)
from alluxio_tpu_torch.parallel.ring_attention import (
    reference_attention, ring_attention_local)
from alluxio_tpu_torch.parallel.tensor_parallel import (copy_to_group,
                                                        reduce_from_group)
from alluxio_tpu_torch.utils.pytree import tree_leaves

#: weight of the Switch-style balance loss in the training objective
MOE_AUX_WEIGHT = 0.01


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_or_patch_dim: int = 768   # input projection dim (patch bytes)
    d_model: int = 256
    n_heads: int = 8
    d_ff: int = 1024
    n_layers: int = 4
    n_classes: int = 1000
    max_len: int = 256
    dtype: Any = torch.bfloat16
    #: >0 switches the FFN to a top-1 MoE with this many experts (the
    #: second model family)
    moe_experts: int = 0

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def param_shardings(cfg: TransformerConfig) -> Dict[str, Any]:
    """The layout of each parameter, as a tree shaped like
    ``Transformer.param_tree()``: tensor-parallel over heads and FF
    columns (``model`` axis), experts as :func:`moe_param_specs`, the
    rest whole (the JAX package's ``param_shardings``)."""
    layer = {
        "ln1": {"scale": REPLICATED},
        "wqkv": Layout(2, MODEL_AXIS),
        "wo": Layout(0, MODEL_AXIS),
        "ln2": {"scale": REPLICATED},
    }
    if cfg.moe_experts > 0:
        layer["moe"] = moe_param_specs()
    else:
        layer["w1"] = Layout(1, MODEL_AXIS)
        layer["w2"] = Layout(0, MODEL_AXIS)
    return {
        "embed": REPLICATED,
        "pos": REPLICATED,
        "head": REPLICATED,
        "final_ln": {"scale": REPLICATED},
        "layers": [layer for _ in range(cfg.n_layers)],
    }


def _scale_dict(cfg: TransformerConfig, device) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": nn.Parameter(
        torch.ones(cfg.d_model, dtype=cfg.dtype, device=device))})


class _Layer(nn.Module):
    def __init__(self, cfg: TransformerConfig, dense, gen, device) -> None:
        super().__init__()
        d, h, k = cfg.d_model, cfg.n_heads, cfg.d_head
        self.ln1 = _scale_dict(cfg, device)
        self.wqkv = nn.Parameter(dense((d, 3, h, k)))
        self.wo = nn.Parameter(dense((h, k, d)))
        self.ln2 = _scale_dict(cfg, device)
        if cfg.moe_experts > 0:
            self.moe = nn.ParameterDict({
                name: nn.Parameter(t) for name, t in init_moe_params(
                    gen, n_experts=cfg.moe_experts, d_model=d,
                    d_ff=cfg.d_ff, dtype=cfg.dtype, device=device).items()})
        else:
            self.w1 = nn.Parameter(dense((d, cfg.d_ff)))
            self.w2 = nn.Parameter(dense((cfg.d_ff, d)))

    def param_tree(self) -> Dict[str, Any]:
        tree = {"ln1": {"scale": self.ln1["scale"]}, "wqkv": self.wqkv,
                "wo": self.wo, "ln2": {"scale": self.ln2["scale"]}}
        if hasattr(self, "moe"):
            tree["moe"] = {name: self.moe[name]
                           for name in ("gate", "w_in", "w_out")}
        else:
            tree["w1"] = self.w1
            tree["w2"] = self.w2
        return tree


class Transformer(nn.Module):
    """The flagship model on ``device`` (``None``: the card). Weights are
    normal x 0.02 (MoE experts: as ``init_moe_params``), drawn in float32
    from a CPU ``torch.Generator`` seeded with ``seed`` and cast to
    ``cfg.dtype``, so one seed gives the same weights on every device.

    With ``mesh`` the model holds this rank's shards on the mesh's
    device: the whole tensors are drawn as above on the CPU, then sliced
    by :func:`param_shardings`, so one seed gives the same whole weights
    at every mesh shape. ``device`` must then be None or that device."""

    def __init__(self, cfg: TransformerConfig, *, device=None, mesh=None,
                 seed: int = 0) -> None:
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            target = mesh_device(mesh)
            asked = torch.device(device if device is not None else target)
            if asked.type != target.type or asked.index not in (
                    None, target.index):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{target}")
            device = torch.device("cpu")
        else:
            device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)

        def dense(shape):
            x = torch.randn(shape, generator=gen) * 0.02
            return x.to(device=device, dtype=cfg.dtype)

        self.embed = nn.Parameter(dense((cfg.vocab_or_patch_dim,
                                         cfg.d_model)))
        self.pos = nn.Parameter(dense((cfg.max_len, cfg.d_model)))
        self.head = nn.Parameter(dense((cfg.d_model, cfg.n_classes)))
        self.final_ln = _scale_dict(cfg, device)
        self.layers = nn.ModuleList(_Layer(cfg, dense, gen, device)
                                    for _ in range(cfg.n_layers))
        if mesh is not None:
            with torch.no_grad():
                for p, lay in zip(self.leaves(), self.layouts()):
                    p.data = shard(p.data, lay, mesh).to(target)

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as the JAX ``init_params`` tree (same keys,
        same nesting); its leaves are this module's ``nn.Parameter``s."""
        return {"embed": self.embed, "pos": self.pos, "head": self.head,
                "final_ln": {"scale": self.final_ln["scale"]},
                "layers": [layer.param_tree() for layer in self.layers]}

    def leaves(self):
        """The parameters in ``jax.tree_util`` flatten order."""
        return tree_leaves(self.param_tree())

    def layouts(self):
        """Each leaf's :class:`Layout`, in the order of :meth:`leaves`."""
        return tree_leaves(param_shardings(self.cfg))

    @torch.no_grad()
    def load_param_tree(self, tree) -> None:
        """Copy a tree of tensors shaped like :meth:`param_tree` into the
        parameters; shapes and dtypes must match exactly."""
        new = tree_leaves(tree)
        mine = self.leaves()
        # a flat list in flatten order is a tree of the same leaves
        if len(new) != len(mine):
            raise ValueError(f"tree has {len(new)} leaves; the model has "
                             f"{len(mine)}")
        for i, (p, t) in enumerate(zip(mine, new)):
            if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
                raise ValueError(
                    f"leaf {i}: {tuple(t.shape)} {t.dtype} != model "
                    f"{tuple(p.shape)} {p.dtype}")
            p.copy_(t)

    def forward(self, tokens) -> torch.Tensor:
        return forward(self, tokens)


def _rms_norm(x, scale):
    var = x.float().square().mean(dim=-1, keepdim=True)
    # bf16 x float32 promotes to float32; cast back before the scale
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def _split_in(x, mesh):
    """The input of a product split over ``model``."""
    return x if mesh is None else \
        copy_to_group(x, mesh.get_group(MODEL_AXIS))


def _split_out(y, mesh):
    """The partial output of a product split over ``model``, summed."""
    return y if mesh is None else \
        reduce_from_group(y, mesh.get_group(MODEL_AXIS))


def _attention(x, layer: _Layer, mesh, seq_axis: Optional[str]):
    qkv = torch.einsum("btd,dshk->sbthk", _split_in(x, mesh), layer.wqkv)
    if seq_axis is not None:
        out = ring_attention_local(qkv[0], qkv[1], qkv[2],
                                   group=mesh.get_group(seq_axis),
                                   causal=False)
    else:
        out = reference_attention(qkv[0], qkv[1], qkv[2], causal=False)
    return _split_out(torch.einsum("bthk,hkd->btd", out, layer.wo), mesh)


def _mlp(x, layer: _Layer, mesh):
    if hasattr(layer, "moe"):
        return moe_ffn(layer.moe, x, mesh=mesh)
    h = torch.einsum("btd,df->btf", _split_in(x, mesh), layer.w1)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    return _split_out(torch.einsum("btf,fd->btd", h, layer.w2), mesh)


def forward_with_aux(model: Transformer, tokens, *,
                     seq_axis: Optional[str] = None):
    """tokens: (B, T, vocab_or_patch_dim) float inputs (flattened patches
    from decode). Returns ((B, n_classes) float32 logits, aux) where
    ``aux`` is the summed MoE load-balance loss (0 when dense). Under a
    mesh, ``tokens`` are this rank's rows and so are the logits; with
    ``seq_axis``, this rank's T-shard, and the logits and aux are the
    shard's own (see the module docstring)."""
    cfg, mesh = model.cfg, model.mesh
    if seq_axis is not None and mesh is None:
        raise ValueError(f"seq_axis={seq_axis!r} needs a model on a mesh")
    # the balance loss's means span the data group, as JAX's span the
    # global batch; per shard under seq_axis, as inside JAX's shard_map
    data = None if mesh is None or seq_axis is not None \
        else mesh.get_group(DATA_AXIS)
    x = torch.einsum("btp,pd->btd", tokens.to(cfg.dtype), model.embed)
    t = x.shape[1]
    x = x + model.pos[:t][None]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in model.layers:
        x = x + _attention(_rms_norm(x, layer.ln1["scale"]), layer, mesh,
                           seq_axis)
        ffn_in = _rms_norm(x, layer.ln2["scale"])
        if hasattr(layer, "moe"):
            aux = aux + load_balance_loss(layer.moe, ffn_in,
                                          group=data).float()
        x = x + _mlp(ffn_in, layer, mesh)
    x = _rms_norm(x, model.final_ln["scale"])
    pooled = x.mean(dim=1)
    logits = torch.einsum("bd,dc->bc", pooled, model.head).float()
    return logits, aux


def forward(model: Transformer, tokens, *,
            seq_axis: Optional[str] = None) -> torch.Tensor:
    return forward_with_aux(model, tokens, seq_axis=seq_axis)[0]


def loss_fn(model: Transformer, tokens, labels, *,
            seq_axis: Optional[str] = None) -> torch.Tensor:
    """Mean cross-entropy (float32) plus ``MOE_AUX_WEIGHT`` x aux; under
    a mesh, the mean over this rank's rows; with ``seq_axis``, this
    shard's loss."""
    logits, aux = forward_with_aux(model, tokens, seq_axis=seq_axis)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None]).mean()
    return nll + MOE_AUX_WEIGHT * aux


def images_to_tokens(images, patch: int = 16):
    """(B,H,W,C) -> (B, T, patch*patch*C): patchify outside the model so
    the embed product is one large matmul."""
    b, h, w, c = images.shape
    ph, pw = h // patch, w // patch
    x = images.reshape(b, ph, patch, pw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, ph * pw, patch * patch * c)
