"""Pipeline parallelism: the GPipe fill-drain schedule over a ``pipe``
mesh axis, the port of ``alluxio_tpu/parallel/pipeline.py``.

Rank ``s`` of the axis holds stage ``s``. With ``S`` stages and ``M``
microbatches the loop runs ``S - 1 + M`` steps; stage ``s`` computes on
step ``t`` when ``0 <= t - s < M``, and each step's activation moves to
stage ``s + 1`` by a point-to-point exchange. The JAX version rotates
over the whole ring; the edge from the last stage back to the first
feeds nothing (stage 0 reads the microbatches), so the port leaves it
out. The last stage holds the outputs; one all-reduce over the axis
gives them to every stage.

It is differentiable in the stage parameters and the microbatches, as
``jax.grad`` through the JAX scan is, on the same fill-drain schedule
run backwards (:class:`_Pipeline`). Storage: the forward keeps each
stage's input for each microbatch, and the backward runs the stage
again on it to take its gradients, so ``stage_fn`` must give the same
result on a second call (no randomness of its own).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from alluxio_tpu_torch.parallel.mesh import ring_exchange
from alluxio_tpu_torch.utils.pytree import tree_leaves, tree_unflatten

PIPE_AXIS = "pipe"


def pipeline_apply(stage_fn, stage_params, x_microbatches, *, mesh,
                   axis: str = PIPE_AXIS):
    """Run microbatches through the stages; returns the ``(M, ...)``
    outputs after all ``S`` stages, on every rank.

    - ``stage_fn(params, x) -> x``: one stage's compute (same shape in
      and out);
    - ``stage_params``: this rank's slice of the stage stack, a tree
      whose leaves have a leading stage dim of 1 (what
      ``shard(full, Layout(0, axis), mesh)`` gives of the ``S``-stage
      stack that JAX shards over ``axis``);
    - ``x_microbatches``: ``(M, ...)``, the same on every rank.

    Differentiable in both. Every rank is taken to compute the same
    loss from the same outputs, as JAX computes one loss from its
    replicated result: the upstream gradient is read once, on the last
    stage. Each rank gets its own stage slice's gradient, and every rank
    the whole gradient of ``x_microbatches``."""
    leaves = tree_leaves(stage_params)
    if any(p.shape[0] != 1 for p in leaves):
        raise ValueError("stage_params leaves need a leading stage dim of "
                         "1: this rank's slice of the stack")
    return _Pipeline.apply(stage_fn, stage_params, mesh.get_group(axis),
                           x_microbatches, *leaves)


class _Pipeline(torch.autograd.Function):
    """The fill-drain forward, keeping each active step's stage input;
    the backward walks the same steps in reverse. On step ``t`` an
    active stage runs ``stage_fn`` again on its kept input, takes the
    gradients of its parameters and its input against its output's
    gradient (the upstream gradient on the last stage, otherwise what
    stage ``s + 1`` sent on step ``t + 1``) and sends the input's
    gradient to stage ``s - 1``. Only active steps exchange: a stage
    receives on step ``t`` exactly when stage ``s + 1`` was active then.
    Stage 0's input gradients are the microbatches' gradient, broadcast
    to every stage."""

    @staticmethod
    def forward(ctx, stage_fn, stage_params, group, xs, *leaves):
        n_stages = dist.get_world_size(group)
        stage = dist.get_rank(group)
        params = tree_unflatten(stage_params, [p[0] for p in leaves])
        n_micro = xs.shape[0]
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        inputs = [None] * n_micro
        for t in range(n_stages - 1 + n_micro):
            x_in = xs[t] if stage == 0 and t < n_micro else buf
            active = 0 <= t - stage < n_micro
            if active:
                inputs[t - stage] = x_in
                y = stage_fn(params, x_in)
            else:
                y = x_in
            if stage == n_stages - 1 and active:
                outs[t - (n_stages - 1)] = y
            # to the next stage, from the previous one (the ends have one)
            sends = [y.contiguous()] if stage < n_stages - 1 else []
            recvs = [torch.empty_like(buf)] if stage > 0 else []
            for w in ring_exchange(sends, recvs, to=stage + 1,
                                   frm=stage - 1, group=group):
                w.wait()
            if recvs:
                buf = recvs[0]
        dist.all_reduce(outs, group=group)
        ctx.stage_fn, ctx.stage_params, ctx.group = \
            stage_fn, stage_params, group
        ctx.save_for_backward(*inputs, *leaves)
        ctx.n_micro = n_micro
        return outs

    @staticmethod
    def backward(ctx, d_outs):
        group = ctx.group
        n_stages = dist.get_world_size(group)
        stage = dist.get_rank(group)
        n_micro = ctx.n_micro
        saved = ctx.saved_tensors
        inputs, leaves = saved[:n_micro], saved[n_micro:]
        params = [p[0].detach().requires_grad_() for p in leaves]
        tree = tree_unflatten(ctx.stage_params, params)
        grads = [None] * len(params)
        d_xs = torch.zeros((n_micro, *inputs[0].shape),
                           dtype=inputs[0].dtype, device=inputs[0].device)
        g_buf = None
        for t in reversed(range(n_stages - 1 + n_micro)):
            j = t - stage
            sends = []
            if 0 <= j < n_micro:
                g_y = d_outs[j] if stage == n_stages - 1 else g_buf
                x = inputs[j].detach().requires_grad_()
                with torch.enable_grad():
                    y = ctx.stage_fn(tree, x)
                g_x, *g_p = torch.autograd.grad(y, [x, *params], g_y,
                                                allow_unused=True)
                grads = [a if b is None else b if a is None else a + b
                         for a, b in zip(grads, g_p)]
                if stage == 0:
                    d_xs[j] = g_x
                else:
                    sends = [g_x.contiguous()]
            # stage s + 1 sends on step t when it is active on it
            recvs = [torch.empty_like(inputs[0])] \
                if stage < n_stages - 1 and 0 <= j - 1 < n_micro else []
            for w in ring_exchange(sends, recvs, to=stage - 1,
                                   frm=stage + 1, group=group):
                w.wait()
            if recvs:
                g_buf = recvs[0]
        dist.broadcast(d_xs, src=dist.get_global_rank(group, 0),
                       group=group)
        d_leaves = [torch.zeros_like(p) if g is None else g[None]
                    for p, g in zip(leaves, grads)]
        return (None, None, None, d_xs, *d_leaves)
