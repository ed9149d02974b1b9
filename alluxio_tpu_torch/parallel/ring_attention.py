"""Attention on one card and ring attention across ranks: the port of
``alluxio_tpu/parallel/ring_attention.py``.

Shapes are ``[B, T, H, D]``. Scores, softmax and the value product are
computed in float32 and the output is cast back to q's dtype, as in the
JAX package.

Ring attention shards the sequence over a group: each rank holds a
``T/n`` block of q, k and v. K/V blocks travel round the ring (rank j
sends to j-1, so after i steps rank r holds block ``(r+i) % n``) while a
float32 running max, denominator and output merge the blocks by
log-sum-exp; causal masking uses global offsets. Each rotation is posted
before the current block's products and awaited after them, so the
transfer overlaps the compute. The ring makes ``n - 1`` rotations: the
JAX scan's ``n``-th returns every block home and feeds nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from alluxio_tpu_torch.parallel.mesh import forward_only, ring_exchange


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


def _block_attention(q, k, v, *, bias=None, scale: float):
    """One (q-block, kv-block) pair in float32: the unnormalised output
    ``[B, Tq, H, D]``, the row max and the row denominator
    ``[B, H, Tq, 1]``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        scores = scores + bias
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o, m, l


def ring_attention_local(q, k, v, *, group, causal: bool = True):
    """This rank's ``[B, T/n, H, D]`` output from its q, k and v blocks,
    the sequence sharded over ``group`` in rank order. Forward only: the
    K/V rotation carries no gradient, and it raises if autograd would
    record through it."""
    forward_only("ring_attention", q, k, v)
    with torch.no_grad():
        return _ring(q, k, v, group=group, causal=causal)


def _ring(q, k, v, *, group, causal: bool):
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    b, t_local, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    qf = q.float()
    k_cur = k.float().contiguous()
    v_cur = v.float().contiguous()
    o_acc = torch.zeros((b, t_local, h, d), dtype=torch.float32,
                        device=q.device)
    m_acc = torch.full((b, h, t_local, 1), -torch.inf, dtype=torch.float32,
                       device=q.device)
    l_acc = torch.zeros((b, h, t_local, 1), dtype=torch.float32,
                        device=q.device)
    for i in range(n):
        works = []
        if i < n - 1:  # the next block, in flight during this one
            k_next, v_next = torch.empty_like(k_cur), torch.empty_like(v_cur)
            works = ring_exchange([k_cur, v_cur], [k_next, v_next],
                                  to=(me - 1) % n, frm=(me + 1) % n,
                                  group=group)
        bias = None
        if causal:
            bias = _causal_bias(t_local, t_local, me * t_local,
                                ((me + i) % n) * t_local, torch.float32,
                                device=q.device)[None, None]
        o, m, l = _block_attention(qf, k_cur, v_cur, bias=bias, scale=scale)
        m_new = torch.maximum(m_acc, m)
        alpha = torch.exp(m_acc - m_new)
        beta = torch.exp(m - m_new)
        o_acc = o_acc * alpha.transpose(1, 2) + o * beta.transpose(1, 2)
        l_acc = l_acc * alpha + l * beta
        m_acc = m_new
        for w in works:
            w.wait()
        if works:
            k_cur, v_cur = k_next, v_next
    out = o_acc / torch.clamp(l_acc, min=1e-20).transpose(1, 2)
    return out.to(q.dtype)


def ring_attention(q, k, v, *, mesh, axis: str = "data",
                   causal: bool = True):
    """Sequence-parallel attention over ``axis`` of ``mesh``: q, k and v
    are this rank's T-shard of ``[B, T, H, D]`` (shard ``r`` of the
    axis holds rows ``[r*T/n, (r+1)*T/n)``); returns its T-shard of the
    output. Forward only (see :func:`ring_attention_local`)."""
    return ring_attention_local(q, k, v, group=mesh.get_group(axis),
                                causal=causal)
