"""Input-doctor vocabulary: serving-tier and op-size buckets.

A copy of ``alluxio_tpu/metrics/stall.py``. Every block read is
attributed to the tier that served it, and the top-ranked stall bucket
keys the operator advice.
"""

from __future__ import annotations

#: serving-tier buckets the input doctor attributes waits to:
#: hbm (device-resident hit), shm (same-host mmap ~= DRAM),
#: remote (cached on a remote worker), ufs (cold read-through)
STALL_BUCKETS = ("hbm", "shm", "remote", "ufs", "unknown")

#: op-size buckets: small-read stalls (per-op overhead) must be
#: distinguishable from stripe-sized ones (bandwidth)
SIZE_BUCKETS = ("le4k", "le64k", "le1m", "gt1m")


def size_bucket(nbytes: int) -> str:
    """The op-size bucket a read of ``nbytes`` falls in."""
    if nbytes <= 4 << 10:
        return "le4k"
    if nbytes <= 64 << 10:
        return "le64k"
    if nbytes <= 1 << 20:
        return "le1m"
    return "gt1m"


#: per-bucket operator hint, ranked bottleneck -> what to turn
BUCKET_ADVICE = {
    "ufs": "cold UFS reads dominate — warm the cache or enable "
           "clairvoyant prefetch (atpu.prefetch.*)",
    "remote": "remote-worker reads dominate — co-locate the client "
              "with its workers or raise replication",
    "shm": "short-circuit host reads dominate — raise device-tier "
           "retention (hbm_bytes) or loader prefetch depth",
    "hbm": "waits are device-tier hits — the input path keeps up; "
           "the job is compute-bound",
    "unknown": "waits could not be attributed — check worker version "
               "(source tagging) and loader wiring",
}
