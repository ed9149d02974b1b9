"""Device-tier evictions (``Client.HbmEvictions``, the pages the policy
evicted to make room) over the blocks the consumer took in the window
(``Client.InputStallCount`` over all tiers, as ``device_tier_hit_pct``
counts them)."""

from benchmark.metrics.device_tier_hit_pct import TIERS

EVICTIONS = "Client.HbmEvictions"


def read(run):
    c = run.counters
    taken = sum(c.get(f"Client.InputStallCount.{t}", 0) for t in TIERS)
    if EVICTIONS not in c or taken <= 0:
        return None
    return c[EVICTIONS] / taken
