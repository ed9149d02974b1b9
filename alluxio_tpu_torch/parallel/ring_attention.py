"""Attention on one card: the port of ``reference_attention`` and
``_causal_bias`` from ``alluxio_tpu/parallel/ring_attention.py``.

Shapes are ``[B, T, H, D]``. Scores, softmax and the value product are
computed in float32 and the output is cast back to q's dtype, as in the
JAX package. ``ring_attention``/``ring_attention_local`` rotate K/V
blocks between cards and come with the NCCL slice.
"""

from __future__ import annotations

import torch


def _causal_bias(t_q: int, t_k: int, q_offset, k_offset, dtype,
                 device=None) -> torch.Tensor:
    """Bias masking keys that are in the future of each query, with
    global offsets (``-1e9`` where masked, else 0)."""
    q_idx = q_offset + torch.arange(t_q, dtype=torch.int32,
                                    device=device)[:, None]
    k_idx = k_offset + torch.arange(t_k, dtype=torch.int32,
                                    device=device)[None, :]
    bias = torch.zeros((t_q, t_k), dtype=dtype, device=device)
    return bias.masked_fill(k_idx > q_idx, -1e9)


def reference_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Single-card attention, float32 inside, q's dtype out."""
    b, t, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        scores = scores + _causal_bias(t, t, 0, 0, torch.float32,
                                       device=q.device)[None, None]
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
