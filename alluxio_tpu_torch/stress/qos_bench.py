"""Two-tenant QoS bench (a copy of ``alluxio_tpu/stress/qos_bench.py``, over
the port's ``UfsBlockFetcher`` and ``PriorityExecutor``): a victim's read
p99 under an abusive tenant's flood, with and without QoS — plus the
master admission limiter's bounded-memory shedding throughput.

Model, not wall-clock luck (the bench-health/selfheal discipline): the
UFS is simulated with a fixed per-read round trip that DWARFS host
thread-wake jitter, so the p99s measure *queueing*, which is the thing
QoS changes.  Three legs:

1. **victim solo** — the well-behaved tenant reads cold blocks alone
   through a ``UfsBlockFetcher`` over a ``per_mount_limit``-bounded
   executor.  Its p99 is the baseline.
2. **victim under flood, QoS ON** — the abusive tenant pre-loads a deep
   backlog of PREFETCH-class fetches; the victim's ON_DEMAND reads must
   stay within ``--max-degradation`` (default 2x) of solo: the priority
   queue drains the victim first and the tenant cap
   (``tenant_limit < per_mount_limit``) keeps slots free for it.
   **This is the gate.**
3. **victim under flood, QoS OFF** — same flood over the FIFO executor
   (the QoS-off behavior).  Reported as the degradation QoS removes; the
   bench fails if FIFO is NOT worse than QoS (the flood failed to
   saturate, so leg 2 proved nothing).

The admission leg floods an :class:`AdmissionController` from far more
principals than its ``max_principals`` cap on a fake clock, asserting
bucket memory stays bounded while over-rate calls shed (not queue), and
reports checks/sec — the per-RPC cost of the gate.

One JSON line on stdout (suite row ``qos-two-tenant``).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import List

from alluxio_tpu_torch.stress.base import BenchResult, percentiles


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


class _ModelUfs:
    """UFS stand-in: every ranged read costs one fixed round trip."""

    def __init__(self, rtt_s: float) -> None:
        self._rtt = rtt_s

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        time.sleep(self._rtt)
        return b"\0" * length


def _victim_latencies(fetcher, ufs, *, block_ids: List[int],
                      block_bytes: int, mount_id: int = 0) -> List[float]:
    from alluxio_tpu_torch.qos import ON_DEMAND
    from alluxio_tpu_torch.worker.ufs_io import UfsBlockDescriptor

    out = []
    for bid in block_ids:
        desc = UfsBlockDescriptor(block_id=bid, ufs_path=f"/v/{bid}",
                                  offset=0, length=block_bytes,
                                  mount_id=mount_id)
        t0 = time.monotonic()
        fetcher.fetch(ufs, desc, cache=False, priority=ON_DEMAND,
                      tenant="victim").result()
        out.append(time.monotonic() - t0)
    return out


def _flood(fetcher, ufs, *, blocks: int, block_bytes: int,
           first_block_id: int, mount_id: int = 0) -> None:
    from alluxio_tpu_torch.qos import PREFETCH
    from alluxio_tpu_torch.worker.ufs_io import UfsBlockDescriptor

    for i in range(blocks):
        bid = first_block_id + i
        desc = UfsBlockDescriptor(block_id=bid, ufs_path=f"/a/{bid}",
                                  offset=0, length=block_bytes,
                                  mount_id=mount_id)
        fetcher.fetch(ufs, desc, cache=False, priority=PREFETCH,
                      tenant="abuser")


def _drain(fetcher, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with fetcher._lock:
            if not fetcher._inflight:
                return
        time.sleep(0.01)


def run(*, rtt_ms: float = 40.0, block_kb: int = 64,
        victim_reads: int = 12, flood_blocks: int = 48,
        per_mount_limit: int = 4, tenant_limit: int = 2,
        max_degradation: float = 2.0,
        admission_checks: int = 200_000,
        admission_principals: int = 20_000,
        admission_max_principals: int = 512) -> BenchResult:
    from alluxio_tpu_torch.qos.admission import AdmissionConf, AdmissionController
    from alluxio_tpu_torch.worker.ufs_fetch import FetchConf, UfsBlockFetcher

    rtt_s = rtt_ms / 1000.0
    block_bytes = block_kb << 10
    ufs = _ModelUfs(rtt_s)
    errors = 0
    t_start = time.monotonic()

    def make_fetcher(qos: bool) -> UfsBlockFetcher:
        # one whole-block stripe per fetch: each fetch is one executor
        # task, so the queueing the bench measures is task queueing
        return UfsBlockFetcher(None, FetchConf(
            stripe_size=block_bytes, concurrency=1,
            per_mount_limit=per_mount_limit, qos_enabled=qos,
            tenant_limit=tenant_limit))

    # --- leg 1: victim solo (baseline) ----------------------------------
    f = make_fetcher(True)
    solo = _victim_latencies(f, ufs, block_ids=range(1, victim_reads + 1),
                             block_bytes=block_bytes)
    f.close()
    solo_p = percentiles(solo)
    log(f"[qos] victim solo p99 {solo_p['p99_us'] / 1e3:.1f} ms "
        f"(rtt {rtt_ms} ms)")

    def flooded_leg(qos: bool) -> dict:
        fetcher = make_fetcher(qos)
        _flood(fetcher, ufs, blocks=flood_blocks,
               block_bytes=block_bytes, first_block_id=10_000)
        # flood keeps coming while the victim reads: a second wave lands
        # mid-measurement from another thread, as a real tenant would
        refill = threading.Thread(
            target=_flood, args=(fetcher, ufs),
            kwargs=dict(blocks=flood_blocks, block_bytes=block_bytes,
                        first_block_id=20_000), daemon=True)
        refill.start()
        lat = _victim_latencies(
            fetcher, ufs, block_ids=range(30_000, 30_000 + victim_reads),
            block_bytes=block_bytes)
        refill.join(timeout=30)
        _drain(fetcher)
        fetcher.close()
        return percentiles(lat)

    # --- leg 2: flood with QoS ON (the gate) ----------------------------
    qos_p = flooded_leg(True)
    log(f"[qos] victim p99 under flood, QoS ON: "
        f"{qos_p['p99_us'] / 1e3:.1f} ms")
    # --- leg 3: flood with QoS OFF (the evidence) -----------------------
    fifo_p = flooded_leg(False)
    log(f"[qos] victim p99 under flood, QoS OFF: "
        f"{fifo_p['p99_us'] / 1e3:.1f} ms")

    degradation = qos_p["p99_us"] / max(1.0, solo_p["p99_us"])
    fifo_degradation = fifo_p["p99_us"] / max(1.0, solo_p["p99_us"])
    if degradation > max_degradation:
        errors += 1
        log(f"[qos] FAIL: victim p99 degraded {degradation:.2f}x under "
            f"flood with QoS on (max {max_degradation}x)")
    if fifo_p["p99_us"] <= qos_p["p99_us"]:
        errors += 1
        log("[qos] FAIL: FIFO flood was not worse than QoS — the flood "
            "did not saturate the executor, gate proves nothing")

    # --- admission leg: bounded-memory shedding -------------------------
    t = [0.0]
    adm = AdmissionController(
        AdmissionConf(enabled=True, rate=5.0, burst=10.0,
                      max_principals=admission_max_principals),
        clock=lambda: t[0])
    from alluxio_tpu_torch.utils.exceptions import ResourceExhaustedError

    shed = 0
    t0 = time.monotonic()
    for i in range(admission_checks):
        t[0] += 1e-4  # 10k calls per fake second >> every rate
        # half the load is ONE flooding principal (must shed), half is
        # principal-name churn (must stay bounded, not shed — each
        # minted name is seen once and LRU-evicted)
        who = "abuser" if i % 2 else f"tenant-{i % admission_principals}"
        try:
            adm.check(who, "create_file")
        except ResourceExhaustedError:
            shed += 1
    admission_wall = time.monotonic() - t0
    checks_per_s = admission_checks / max(1e-9, admission_wall)
    tracked = adm.report()
    if tracked["admitted_total"] + tracked["shed_total"] \
            != admission_checks:
        errors += 1
        log("[qos] FAIL: admission counters do not add up")
    # bounded memory is the acceptance criterion: a 20k-principal flood
    # must not grow state past the configured cap
    principals_tracked = len(adm._buckets)
    if principals_tracked > admission_max_principals:
        errors += 1
        log(f"[qos] FAIL: {principals_tracked} principal buckets "
            f"tracked, cap {admission_max_principals}")
    if shed == 0:
        errors += 1
        log("[qos] FAIL: the flood shed nothing — limiter inert")
    log(f"[qos] admission: {checks_per_s / 1e3:.0f}k checks/s, "
        f"{shed} shed, {principals_tracked} buckets "
        f"(cap {admission_max_principals})")

    return BenchResult(
        bench="qos-two-tenant",
        params={"rtt_ms": rtt_ms, "block_kb": block_kb,
                "victim_reads": victim_reads,
                "flood_blocks": 2 * flood_blocks,
                "per_mount_limit": per_mount_limit,
                "tenant_limit": tenant_limit,
                "max_degradation_x": max_degradation,
                "admission_checks": admission_checks,
                "admission_principals": admission_principals},
        metrics={
            "victim_solo_p99_ms": round(solo_p["p99_us"] / 1e3, 2),
            "victim_flood_qos_p99_ms": round(qos_p["p99_us"] / 1e3, 2),
            "victim_flood_fifo_p99_ms": round(fifo_p["p99_us"] / 1e3, 2),
            "victim_degradation_qos_x": round(degradation, 3),
            "victim_degradation_fifo_x": round(fifo_degradation, 3),
            "gate": f"victim p99 under flood <= {max_degradation}x solo "
                    f"with QoS on",
            "admission_checks_per_s": round(checks_per_s, 0),
            "admission_shed": shed,
            "admission_buckets_tracked": principals_tracked,
            "admission_buckets_cap": admission_max_principals,
        },
        errors=errors, duration_s=time.monotonic() - t_start)
