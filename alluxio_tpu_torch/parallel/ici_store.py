"""The mesh data plane: warm cached blocks sharded over the ranks of a
mesh axis, served to peers by collectives instead of per-block reads.

The port of ``alluxio_tpu/parallel/ici_store.py``. There, one
controller builds one global array sharded over the devices and reads
it with XLA collectives over ICI; here, each rank (one process per
card) holds its own shard and the reads are ``torch.distributed``
collectives over NVLink (NCCL) or, for CPU tensors, gloo:

- :meth:`MeshBlockCache.load_global` reads only this rank's rows from
  the host-local worker tier and moves its shard to the device in one
  copy. Rank ``d`` of the axis holds global blocks
  ``[d*per_dev, (d+1)*per_dev)``; the ragged tail is zeros;
- :meth:`~MeshBlockCache.gather_all` (all-gather),
  :meth:`~MeshBlockCache.ring_shift` (point-to-point ring),
  :meth:`~MeshBlockCache.global_batch` (one all-reduce of the batch
  buffer, never the warm set) and :meth:`~MeshBlockCache.replicate`
  (broadcast from the owner) read the warm set with no host traffic;
- :meth:`~MeshBlockCache.turnover` replaces rows in place, moving only
  the changed blocks host to device.

``cached`` is always this rank's shard, a ``(per_dev, elems)`` tensor
on its device; every method that reads it is a collective that every
rank of the axis calls.
"""

from __future__ import annotations

import logging
import socket
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from alluxio_tpu_torch.parallel.mesh import (DATA_AXIS, axis_rank, axis_size,
                                             mesh_device, ring_exchange)

_log = logging.getLogger(__name__)


def _as_words(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` (2-D, contiguous) viewed as the widest integers that
    tile one row."""
    row_bytes = rows.shape[1] * rows.element_size()
    for word in (torch.int64, torch.int32, torch.int16):
        if row_bytes % word.itemsize == 0:
            return rows.view(word)
    return rows.view(torch.uint8)


class MeshBlockCache:
    """Warm block cache sharded over a mesh axis; collective reads.

    One instance manages one dataset (an ordered list of ``(path, block)``
    pairs padded to equal block size). The global order is striped so the
    sharding is contiguous per rank: global index ``g = d*per_dev + k``
    is the ``k``-th block of rank ``d`` of the axis.
    """

    def __init__(self, mesh, *, axis: str = DATA_AXIS,
                 block_bytes: int, dtype=np.uint8,
                 client_host: str = "") -> None:
        self.mesh = mesh
        self.axis = axis
        self.block_bytes = block_bytes
        self.dtype = np.dtype(dtype)
        self.n_devices = axis_size(mesh, axis)
        #: (path, block_index) in global order, set by load_global
        self.plan: List[Tuple[str, int]] = []
        #: global block index -> master block id (for placement reports)
        self.block_ids: List[int] = []
        self.client_host = client_host or socket.gethostname()
        self._block_client = None
        #: path -> master block ids (filled from loaders; avoids a
        #: get_status call per path on every resolve)
        self._bids_by_path: Dict[str, List[int]] = {}
        #: per_dev -> batch assembler
        self._batch_fns: Dict[int, object] = {}
        self._group = mesh.get_group(axis)
        self._pos = axis_rank(mesh, axis)
        self._device = mesh_device(mesh)
        self._torch_dtype = torch.from_numpy(np.empty(0, self.dtype)).dtype

    # -- placement -----------------------------------------------------------
    def placement(self, n_blocks: int) -> Dict[int, int]:
        """global block index -> mesh position (the warm-set block map)."""
        per_dev = -(-n_blocks // self.n_devices)
        return {g: g // per_dev for g in range(n_blocks)}

    # -- load (cold/host path; per-rank locality) ----------------------------
    def load_global(self, fs, paths: Sequence[str], *,
                    loader=None, report: bool = True,
                    io_threads: int = 8) -> torch.Tensor:
        """Materialise this rank's shard of the warm set: its rows are
        read from the host-local worker tier (short-circuit mmap) by
        ``io_threads`` threads into one host buffer (pinned for a card),
        which moves to the device in one copy. No rank reads another's
        rows. Returns the ``(per_dev, elems)`` shard.

        ``report=True`` registers this rank's placement with the master
        block map. ``loader``: an existing ``DeviceBlockLoader`` to
        reuse; else one is built per call."""
        from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader

        own_loader = loader is None
        if own_loader:
            loader = DeviceBlockLoader(fs, paths, device=self._device,
                                       hbm_bytes=0, dtype=self.dtype)
        try:
            self.plan = list(loader.plan)
            self._resolve_block_ids(fs, loader)
            n = len(self.plan)
            per_dev = -(-n // self.n_devices)
            elems = self.block_bytes // self.dtype.itemsize
            host = torch.empty((per_dev, elems), dtype=self._torch_dtype,
                               pin_memory=self._device.type == "cuda")
            rows = host.numpy()

            def read_row(k: int) -> None:
                rows[k] = self._host_row(loader, self._pos * per_dev + k,
                                         n, elems)

            with ThreadPoolExecutor(max_workers=max(1, io_threads)) as ex:
                list(ex.map(read_row, range(per_dev)))
            cached = host.to(self._device)
            if report:
                self.report_placement(fs, [self._pos], per_dev, n)
            return cached
        finally:
            if own_loader:
                loader.close()

    def _host_row(self, loader, g: int, n: int, elems: int):
        if g >= n:  # pad the ragged tail with zeros
            return np.zeros(elems, self.dtype)
        host = loader.host_block(*self.plan[g])
        if host.shape[0] != elems:
            padded = np.zeros(elems, self.dtype)
            padded[:host.shape[0]] = host
            host = padded
        return host

    def _resolve_block_ids(self, fs, loader=None) -> None:
        if loader is not None:  # loader already fetched every status
            self._bids_by_path.update(
                getattr(loader, "block_ids_by_path", {}))
        self.block_ids = []
        for path, idx in self.plan:
            bids = self._bids_by_path.get(path)
            if bids is None:
                bids = self._bids_by_path[path] = \
                    list(fs.get_status(path).block_ids)
            self.block_ids.append(bids[idx] if idx < len(bids) else -1)

    # -- control-plane placement reporting -----------------------------------
    def report_placement(self, fs, my_positions: Sequence[int],
                         per_dev: int, n: int) -> None:
        """Tell the master which blocks are device-resident at which mesh
        position. The master keeps one report per host and a host may
        run several ranks, so this is a collective over the axis: the
        ranks gather their maps, and the lowest rank of each
        ``client_host`` reports that host's positions in one call."""
        mesh_blocks = {}
        for pos in my_positions:
            bids = [self.block_ids[g]
                    for g in range(pos * per_dev,
                                   min((pos + 1) * per_dev, n))
                    if self.block_ids[g] >= 0]
            if bids:
                mesh_blocks[pos] = bids
        reports = [None] * self.n_devices
        dist.all_gather_object(reports, (self.client_host, mesh_blocks),
                               group=self._group)
        hosts = [host for host, _ in reports]
        if hosts.index(self.client_host) != self._pos:
            return
        merged = {}
        for host, blocks in reports:
            if host == self.client_host:
                merged.update(blocks)
        client = self._block_master_client(fs)
        if client is None:
            return
        try:
            client.report_device_blocks(self.client_host, merged)
        except Exception:  # noqa: BLE001 placement is advisory cache state
            _log.warning("device placement report failed", exc_info=True)

    def drop_placement(self, fs) -> None:
        """Warm set released: clear this host's device block map entries
        (pairs with eviction/close)."""
        client = self._block_master_client(fs)
        if client is not None:
            try:
                client.clear_device_blocks(self.client_host)
            except Exception:  # noqa: BLE001 advisory
                _log.warning("device placement clear failed", exc_info=True)

    def _block_master_client(self, fs):
        if self._block_client is None:
            store = getattr(fs, "store", None)
            self._block_client = getattr(store, "block_master", None)
            if self._block_client is None:
                _log.warning("no block-master client on %r: device "
                             "placement reporting disabled",
                             type(fs).__name__)
        return self._block_client

    # -- warm collective reads (zero host traffic) ---------------------------
    def gather_all(self, cached: torch.Tensor) -> torch.Tensor:
        """Every rank materialises ALL blocks: one all-gather, the
        collective replacement for N remote block reads."""
        out = cached.new_empty((self.n_devices * cached.shape[0],
                                *cached.shape[1:]))
        dist.all_gather_into_tensor(out, cached.contiguous(),
                                    group=self._group)
        return out

    def ring_shift(self, cached: torch.Tensor,
                   shift: int = 1) -> torch.Tensor:
        """Each rank receives its ``shift``-th neighbour's shard over the
        ring (rank d receives from ``(d + shift) % n``): the
        sequence-parallel access pattern applied to cached data."""
        n = self.n_devices
        out = torch.empty_like(cached)
        for w in ring_exchange([cached.contiguous()], [out],
                               to=(self._pos - shift) % n,
                               frm=(self._pos + shift) % n,
                               group=self._group):
            w.wait()
        return out

    def global_batch(self, cached: torch.Tensor, indices) -> torch.Tensor:
        """Assemble a batch of blocks by GLOBAL index wherever they live,
        moving O(batch) bytes: each rank takes the requested rows it owns
        from its shard (others contribute zeros), then ONE all-reduce of
        the ``(B, elems)`` buffer merges them; the warm set is never
        gathered. ``indices``: 1-D global block ids (a tensor already on
        the device keeps the call free of host traffic). Every rank gets
        the whole batch."""
        return self.batch_fn(cached.shape[0])(cached, indices)

    def batch_fn(self, per_dev: int):
        """The O(batch) assembler for shards of ``per_dev`` rows, cached
        per ``per_dev``."""
        fn = self._batch_fns.get(per_dev)
        if fn is not None:
            return fn

        def assemble(local: torch.Tensor, indices) -> torch.Tensor:
            idx = torch.as_tensor(indices, device=local.device).long()
            local_idx = idx - self._pos * per_dev
            mine = (local_idx >= 0) & (local_idx < per_dev)
            # rows move as the widest integer words that tile a row: one
            # rank owns each row and the others add zeros, so an integer
            # sum keeps every bit whatever the cache's dtype
            words = _as_words(local)
            rows = words.index_select(0, local_idx.clamp(0, per_dev - 1))
            rows.masked_fill_(~mine[:, None], 0)
            dist.all_reduce(rows, group=self._group)
            return rows.view(local.dtype)

        self._batch_fns[per_dev] = assemble
        return assemble

    def replicate(self, cached: torch.Tensor,
                  block_index: int) -> torch.Tensor:
        """Fan a hot block out to every rank: one broadcast from the rank
        that holds it, not N point-to-point streams. Returns the block,
        ``(elems,)``, on every rank."""
        per_dev = cached.shape[0]
        if not 0 <= block_index < per_dev * self.n_devices:
            raise IndexError(f"global block index {block_index} out of "
                             f"range")
        owner, k = divmod(block_index, per_dev)
        row = cached[k].clone() if owner == self._pos \
            else cached.new_empty(cached.shape[1:])
        dist.broadcast(row, src=dist.get_global_rank(self._group, owner),
                       group=self._group)
        return row

    # -- warm-set turnover (eviction/refresh) --------------------------------
    def turnover(self, cached: torch.Tensor, fs,
                 replacements: Dict[int, Tuple[str, int]], *,
                 loader=None, report: bool = True) -> torch.Tensor:
        """Replace warm-set rows in place: ``replacements`` maps a global
        block index -> a new ``(path, block_index)`` source. Only ranks
        owning a replaced row do IO, and each updates its rows with one
        ``index_copy_`` — O(changed blocks) host->device traffic; the
        shard's memory is reused. The refreshed placement is re-reported
        to the master block map. Returns ``cached``, updated."""
        from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader

        if not replacements:
            return cached
        n = len(self.plan)
        per_dev, elems = cached.shape[0], cached.shape[1]
        # validate EVERY index before mutating the plan: a bad key must
        # not leave plan/device state describing different data
        for g in replacements:
            if not 0 <= g < n:
                raise IndexError(f"global block index {g} out of range")
        for g, src in replacements.items():
            self.plan[g] = tuple(src)
        self._resolve_block_ids(fs)

        touched = sorted(g for g in replacements
                         if g // per_dev == self._pos)
        if touched:
            new_paths = sorted({self.plan[g][0] for g in touched})
            own_loader = loader is None
            if own_loader:
                loader = DeviceBlockLoader(fs, new_paths,
                                           device=self._device,
                                           hbm_bytes=0, dtype=self.dtype)
            try:
                data = np.stack([self._host_row(loader, g, n, elems)
                                 for g in touched])
            finally:
                if own_loader:
                    loader.close()
            rows = torch.tensor([g - self._pos * per_dev for g in touched],
                                device=self._device)
            cached.index_copy_(0, rows, torch.from_numpy(data).to(
                self._device))
        if report:
            self.report_placement(fs, [self._pos], per_dev, n)
        return cached

    # -- introspection -------------------------------------------------------
    def describe_placement(self,
                           cached: torch.Tensor) -> Dict[int, List[int]]:
        """mesh position -> global block ids resident there, for this
        rank's shard (each rank sees its own; JAX's single controller
        sees every device's)."""
        per_dev = cached.shape[0]
        start = self._pos * per_dev
        return {self._pos: list(range(start, start + per_dev))}
