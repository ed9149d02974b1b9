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
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from alluxio_tpu_torch.parallel.mesh import forward_only, ring_exchange
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

    Forward only: the activation exchanges carry no gradient, and it
    raises if autograd would record through them."""
    forward_only("pipeline_apply", x_microbatches,
                 *tree_leaves(stage_params))
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    leaves = tree_leaves(stage_params)
    if any(p.shape[0] != 1 for p in leaves):
        raise ValueError("stage_params leaves need a leading stage dim of "
                         "1: this rank's slice of the stack")
    params = tree_unflatten(stage_params, [p[0] for p in leaves])
    xs = x_microbatches
    n_micro = xs.shape[0]
    with torch.no_grad():
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(n_stages - 1 + n_micro):
            x_in = xs[t] if stage == 0 and t < n_micro else buf
            active = 0 <= t - stage < n_micro
            y = stage_fn(params, x_in) if active else x_in
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
    return outs

