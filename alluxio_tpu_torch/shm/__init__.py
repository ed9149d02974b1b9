"""Same-host zero-copy data plane: the SHM lease protocol (a copy of
``alluxio_tpu/shm/__init__.py``).

The worker's MEM tier lives on ``/dev/shm`` (``atpu.worker.shm.dir``):
a committed top-tier block file *is* a named shared-memory segment.

- the **worker** (``worker/shm_store.py``) grants a co-located client a
  *lease* on a segment: ``shm_open`` returns the file path and a lease
  id, and pins the block in ``TieredBlockStore`` so eviction cannot
  unlink it while mapped. Leases are TTL-bounded, not session-bound: a
  killed client's pins expire one TTL later, while live clients renew
  lazily through ``shm_renew``.
- the **client** (``client/shm_transport.py``) maps the segment once
  and serves every later read of the block from the shared pages: no
  RPC, no serialization, no copy before the host -> device copy.

Every failure in this plane (lease denied, segment unavailable, the
worker forgot the lease, a failed map) is a typed signal that the
client's block-routing ladder (``client/block_store.py``) catches, and
it re-issues the read on the next rung. The plane can make reads
faster, never fail them.

======================  ================================================
RPC                     semantics
======================  ================================================
``shm_open``            grant lease: {lease_id, path, length, ttl_s};
                        raises ShmLeaseDeniedError (table full) or
                        ShmSegmentUnavailableError (not cached in the
                        top tier)
``shm_renew``           extend lease TTL; {ok: False} for an unknown
                        lease (worker restarted) — client re-opens
``shm_release``         drop lease; last lease on a block unpins it
======================  ================================================
"""

from __future__ import annotations

from typing import NamedTuple

from alluxio_tpu_torch.utils.exceptions import (
    AlluxioTpuError, register_wire_error,
)


@register_wire_error
class ShmLeaseDeniedError(AlluxioTpuError):
    """Worker declined to grant an SHM lease (its lease table is at
    ``atpu.worker.shm.max.leases``). The client falls back to the next
    rung of its ladder."""

    code = "RESOURCE_EXHAUSTED"


@register_wire_error
class ShmSegmentUnavailableError(AlluxioTpuError):
    """The block has no mappable top-tier segment on this worker (not
    cached, mid-eviction, or resident on a lower tier). Not an error for
    the read itself: a lower rung serves it."""

    code = "NOT_FOUND"


class ShmLease(NamedTuple):
    """A granted lease, as the client tracks it."""

    lease_id: int
    block_id: int
    path: str
    length: int
    ttl_s: float
    #: monotonic deadline after which the worker may reclaim the pin
    expires_at: float
