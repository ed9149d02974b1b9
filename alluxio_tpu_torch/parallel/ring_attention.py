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
transfer overlaps the compute. The forward makes ``n - 1`` rotations:
the JAX scan's ``n``-th returns every block home and feeds nothing.

It is differentiable in q, k and v, as ``jax.grad`` through the JAX
scan is (:class:`_RingAttention`): the backward goes round the ring
once more, recomputing each block's probabilities from the saved
log-sum-exp, and its dk/dv accumulators travel with the blocks and
take the ``n``-th rotation home. Gradients are computed in float32 and
returned in the inputs' dtypes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from alluxio_tpu_torch.parallel.mesh import ring_exchange


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
    the sequence sharded over ``group`` in rank order; differentiable in
    q, k and v."""
    return _RingAttention.apply(q, k, v, group, causal)


def _ring_peers(group):
    """(n, this rank, the rank sent to, the rank received from)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    return n, me, (me - 1) % n, (me + 1) % n


def _block_bias(causal: bool, t_local: int, me: int, src: int, device):
    """The causal bias of this rank's queries against block ``src``."""
    if not causal:
        return None
    return _causal_bias(t_local, t_local, me * t_local, src * t_local,
                        torch.float32, device=device)[None, None]


def _block_grads(qf, do, k, v, lse, delta, *, bias, scale: float):
    """One held K/V block's part of dq, dk and dv, all float32, with the
    block's probabilities recomputed from the row log-sum-exp."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k) * scale
    if bias is not None:
        s = s + bias
    p = torch.exp(s - lse)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    # dk and dv travel the ring: point-to-point ops need them contiguous
    return dq, dk.contiguous(), dv.contiguous()


class _RingAttention(torch.autograd.Function):
    """The ring forward, saving the local q, k and v, the float32 output
    and the row log-sum-exp ``m + log l``; and its ring backward.

    The backward takes ``delta = sum(dout * out)`` per row and goes round
    the ring again. For each K/V block it holds it adds the block's part
    of dq to its own and the block's parts of dk and dv to the block's
    accumulators. The accumulators travel one step behind their block:
    the exchange of step ``i`` carries the next K/V block and the
    accumulators of the block held at step ``i - 1`` (whose ranks so far
    have all added theirs), posted before the step's products and
    awaited after them. After the last block one more exchange brings
    each rank its own block's accumulators."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        n, me, to, frm = _ring_peers(group)
        b, t_local, h, d = q.shape
        scale = 1.0 / (d ** 0.5)
        qf = q.float()
        k_cur = k.float().contiguous()
        v_cur = v.float().contiguous()
        o_acc = torch.zeros((b, t_local, h, d), dtype=torch.float32,
                            device=q.device)
        m_acc = torch.full((b, h, t_local, 1), -torch.inf,
                           dtype=torch.float32, device=q.device)
        l_acc = torch.zeros((b, h, t_local, 1), dtype=torch.float32,
                            device=q.device)
        for i in range(n):
            works = []
            if i < n - 1:  # the next block, in flight during this one
                k_next = torch.empty_like(k_cur)
                v_next = torch.empty_like(v_cur)
                works = ring_exchange([k_cur, v_cur], [k_next, v_next],
                                      to=to, frm=frm, group=group)
            bias = _block_bias(causal, t_local, me, (me + i) % n, q.device)
            o, m, l = _block_attention(qf, k_cur, v_cur, bias=bias,
                                       scale=scale)
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
        l_acc = torch.clamp(l_acc, min=1e-20)
        out = o_acc / l_acc.transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, m_acc + torch.log(l_acc))
        ctx.group, ctx.causal = group, causal
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        n, me, to, frm = _ring_peers(ctx.group)
        t_local, d = q.shape[1], q.shape[3]
        scale = 1.0 / (d ** 0.5)
        qf, do = q.float(), dout.float()
        # [B, H, Tq, 1], as lse
        delta = (do * out).sum(dim=-1).transpose(1, 2)[..., None]
        dq = torch.zeros_like(qf)
        k_cur = k.float().contiguous()
        v_cur = v.float().contiguous()
        dk = dv = None  # the accumulators of the block held last step
        for i in range(n + 1 if n > 1 else 1):
            sends, recvs = [], []
            if i < n - 1:  # the next block, as in the forward
                nxt = [torch.empty_like(k_cur), torch.empty_like(v_cur)]
                sends, recvs = [k_cur, v_cur], nxt
            if i > 0:  # last step's accumulators, to the next holder
                acc_in = [torch.empty_like(dk), torch.empty_like(dv)]
                sends, recvs = sends + [dk, dv], recvs + acc_in
            works = ring_exchange(sends, recvs, to=to, frm=frm,
                                  group=ctx.group)
            if i < n:
                bias = _block_bias(ctx.causal, t_local, me, (me + i) % n,
                                   q.device)
                dq_blk, dk_blk, dv_blk = _block_grads(
                    qf, do, k_cur, v_cur, lse, delta, bias=bias,
                    scale=scale)
                dq += dq_blk
            for w in works:
                w.wait()
            if i < n - 1:
                k_cur, v_cur = nxt
            if i == 0:
                dk, dv = dk_blk, dv_blk
            elif i < n:
                dk, dv = acc_in[0] + dk_blk, acc_in[1] + dv_blk
            else:  # the n-th rotation: this rank's own block, complete
                dk, dv = acc_in
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(q, k, v, *, mesh, axis: str = "data",
                   causal: bool = True):
    """Sequence-parallel attention over ``axis`` of ``mesh``: q, k and v
    are this rank's T-shard of ``[B, T, H, D]`` (shard ``r`` of the
    axis holds rows ``[r*T/n, (r+1)*T/n)``); returns its T-shard of the
    output. Differentiable in q, k and v."""
    return ring_attention_local(q, k, v, group=mesh.get_group(axis),
                                causal=causal)
