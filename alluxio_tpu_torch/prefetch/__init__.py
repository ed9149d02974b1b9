"""Clairvoyant prefetch: epoch-aware block scheduling into tiers.

The port of ``alluxio_tpu/prefetch``. With a seeded shuffle the exact
per-epoch access order is known before the first step runs, so the data
plane can plan — not guess — which blocks must already be resident in
which tier when the consumer arrives:

- :mod:`~alluxio_tpu_torch.prefetch.oracle` derives the exact future
  access sequence from (manifest, seed, epoch, cursor), with numpy's
  permutation, so both packages shuffle alike;
- :mod:`~alluxio_tpu_torch.prefetch.scheduler` turns the lookahead
  window into tier-placement plans (device tier vs DRAM vs skip) under a
  byte budget, with deadline/lateness tracking and backpressure;
- :mod:`~alluxio_tpu_torch.prefetch.agent` executes plans each
  heartbeat: async worker-tier loads + eviction pins, and device-tier
  adoption through the consumer's
  :class:`~alluxio_tpu_torch.client.torch_io.DeviceBlockLoader`;
- :mod:`~alluxio_tpu_torch.prefetch.service` assembles the loop and
  binds it to a loader.
"""

from alluxio_tpu_torch.prefetch.oracle import (  # noqa: F401
    AccessOracle, BlockRef, DatasetManifest,
)
from alluxio_tpu_torch.prefetch.scheduler import (  # noqa: F401
    PlacementAction, PrefetchScheduler, TIER_DRAM, TIER_HBM,
)
from alluxio_tpu_torch.prefetch.agent import (  # noqa: F401
    JobServiceExecutor, PrefetchAgent, WorkerTierExecutor,
)
from alluxio_tpu_torch.prefetch.service import PrefetchService  # noqa: F401
