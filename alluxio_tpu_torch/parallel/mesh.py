"""The device mesh on ``torch.distributed``: one process per card.

The port of ``alluxio_tpu/parallel/mesh.py``. JAX runs one controller
over every device; PyTorch runs one process per card, each holding its
own shard, joined by a process group (NCCL on cards, gloo for CPU
tensors). A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
named dims over the default group, built by :func:`make_mesh` once the
group exists (``torchrun --nproc-per-node=N`` sets up the environment
that ``init_process_group`` reads).

Axes convention: ``data`` (batch shards), ``model`` (tensor parallel).
A tensor's layout (the counterpart of a ``PartitionSpec``) is a
:class:`Layout`: the one dim split over one mesh axis, or none
(:data:`REPLICATED`). :func:`shard` slices this rank's part of a full
tensor, :func:`gather` rebuilds the full tensor from the parts.

Point-to-point rings (:func:`ring_exchange`) name peers by their rank
within the axis's group. NCCL pairs a rank with itself (a ring of one
is a copy through the backend); gloo does not, so a gloo ring needs two
ranks or more and raises otherwise.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from alluxio_tpu_torch.utils.wire import LocalityTier, TieredIdentity

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: the backend each device type of a mesh needs
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None, *,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the initialised default group, with dims
    named and sized by ``axis_sizes`` (default: every rank on ``data``).

    ``device_type`` None means the card: the mesh runs on ``cuda`` over
    NCCL, and this rank's device becomes ``cuda:<local rank>``
    (``LOCAL_RANK`` from ``torchrun``, else the rank modulo the cards).
    ``"cpu"`` asks for CPU tensors over gloo. The group's backend must
    serve the device type; nothing switches from one to the other."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialised: start the "
            "program with torchrun (or call "
            "torch.distributed.init_process_group) before make_mesh")
    world = dist.get_world_size()
    if not axis_sizes:
        axis_sizes = {DATA_AXIS: world}
    names = tuple(axis_sizes)
    shape = tuple(int(s) for s in axis_sizes.values())
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {dict(axis_sizes)} needs "
                         f"{math.prod(shape)} ranks, the group has {world}")
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; a mesh runs on the card by "
                "default — pass device_type='cpu' for a gloo mesh of CPU "
                "tensors")
        device_type = "cuda"
    if device_type not in _BACKEND:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    backend = dist.get_backend()
    if _BACKEND[device_type] not in backend:
        raise RuntimeError(f"a {device_type} mesh needs the "
                           f"{_BACKEND[device_type]} backend; the process "
                           f"group's is {backend!r}")
    if device_type == "cuda":
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def mesh_device(mesh):
    """This rank's device under ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh, axis: str) -> int:
    """This rank's position along ``axis``."""
    return mesh.get_local_rank(axis)


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a tensor lies on the mesh: dim ``dim`` split in equal,
    contiguous parts over ``axis``, or whole on every rank when both
    are None. A leaf of a layout tree (not a container)."""

    dim: Optional[int] = None
    axis: Optional[str] = None


REPLICATED = Layout()


def layout(*spec) -> Layout:
    """The :class:`Layout` of a ``PartitionSpec``-style spec: one entry
    per dim, a mesh axis name or None (the counterpart of
    ``named_sharding(mesh, *spec)``; no spec is ``replicated(mesh)``)."""
    split = [(i, a) for i, a in enumerate(spec) if a is not None]
    if not split:
        return REPLICATED
    if len(split) > 1 or not isinstance(split[0][1], str):
        raise ValueError(f"one dim over one mesh axis, got {spec}")
    return Layout(*split[0])


@torch.no_grad()
def shard(full, lay: Layout, mesh):
    """This rank's part of ``full`` under ``lay``: a contiguous copy of
    the slice, or ``full`` itself when replicated. Not recorded by
    autograd."""
    if lay.dim is None:
        return full
    n = axis_size(mesh, lay.axis)
    size, rest = divmod(full.shape[lay.dim], n)
    if rest:
        raise ValueError(f"dim {lay.dim} of {tuple(full.shape)} does not "
                         f"split in {n} over {lay.axis!r}")
    part = full.narrow(lay.dim, axis_rank(mesh, lay.axis) * size, size)
    return part.clone(memory_format=torch.contiguous_format)


@torch.no_grad()
def gather(local, lay: Layout, mesh):
    """The full tensor from every rank's part under ``lay`` (one
    ``all_gather`` over the axis's group); a replicated ``local`` is
    returned as it is. Not recorded by autograd."""
    if lay.dim is None:
        return local
    n = axis_size(mesh, lay.axis)
    part = local.movedim(lay.dim, 0).contiguous()
    out = torch.empty((n * part.shape[0], *part.shape[1:]),
                      dtype=part.dtype, device=part.device)
    dist.all_gather_into_tensor(out, part, group=mesh.get_group(lay.axis))
    return out.movedim(0, lay.dim).contiguous()


def shard_host_batch(mesh, host_array, *, axis: str = DATA_AXIS):
    """This rank's rows of a host batch (rows split in equal contiguous
    parts over ``axis``), on this rank's device: the device-side entry
    of the data-parallel read path."""
    t = torch.as_tensor(host_array)
    n = axis_size(mesh, axis)
    rows, rest = divmod(t.shape[0], n)
    if rest:
        raise ValueError(f"{t.shape[0]} rows do not split in {n} over "
                         f"{axis!r}")
    r = axis_rank(mesh, axis)
    return t[r * rows:(r + 1) * rows].to(mesh_device(mesh))


def identity_for_device(device) -> TieredIdentity:
    """The locality of a card or a CPU rank, in the tiers the placement
    policies understand: its node (``torchrun``'s ``GROUP_RANK``, 0
    without it) as the host; for a CUDA device the node is also its
    slice, since NVLink joins the cards of one node; then ``pod-0``."""
    node = int(os.environ.get("GROUP_RANK", "0"))
    tiers = [LocalityTier("host", f"host-{node}")]
    if torch.device(device).type == "cuda":
        tiers.append(LocalityTier("slice", f"slice-{node}"))
    tiers.append(LocalityTier("pod", "pod-0"))
    return TieredIdentity(tiers)


def group_mean(x, group):
    """``x`` summed over ``group`` and divided by its size: a new tensor
    that carries no gradient."""
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


def ring_exchange(sends, recvs, *, to: Optional[int], frm: Optional[int],
                  group) -> List:
    """Send each tensor of ``sends`` to group rank ``to`` and receive
    each of ``recvs`` from group rank ``frm``, in order, as one batch of
    point-to-point ops; returns the works to ``wait()`` on. The sent
    tensors must not change before then. A side with no tensors may
    name no peer."""
    ops = []
    if sends:
        dst = dist.get_global_rank(group, to)
        ops += [dist.P2POp(dist.isend, t, dst, group) for t in sends]
    if recvs:
        src = dist.get_global_rank(group, frm)
        ops += [dist.P2POp(dist.irecv, t, src, group) for t in recvs]
    return dist.batch_isend_irecv(ops) if ops else []


def forward_only(name: str, *tensors) -> None:
    """Raise if autograd would record through ``name``: its
    point-to-point exchanges carry no gradient, so a backward through
    it would be silently wrong."""
    if torch.is_grad_enabled() and any(
            getattr(t, "requires_grad", False) for t in tensors):
        raise RuntimeError(f"{name} is forward only: call it under "
                           f"torch.no_grad() on tensors that need no "
                           f"gradient")
