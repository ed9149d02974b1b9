"""HA failover drill: kill the primary under live load, gate MTTR and
the standby-read staleness contract (suite row ``ha-failover``; a copy of
``alluxio_tpu/stress/ha_bench.py``).

The drill runs a real 3-master EMBEDDED-journal quorum in process
(:class:`~alluxio_tpu_torch.minicluster.ha_cluster.HaCluster`) with a writer
issuing creates through the multi-endpoint failover client and a prober
reading from whichever member is currently a standby.  Mid-run the
primary is killed.  Three things are measured, two gated:

- **MTTR** — last ack before the kill to first ack after it, as the
  CLIENT sees it (election + promotion + redirect, end to end).  Gate:
  ≤ 2 election timeouts (the gate's budget; election upper bound
  dominates, promotion and the leader-hint redirect must fit in the
  rest).
- **No acked write lost** — every create the client saw acknowledged
  must exist on the post-failover primary.  Gate: zero missing.
- **Standby staleness contract** — a standby response stamped
  ``md_version v`` must include every write whose primary-side stamp is
  ``<= v`` (the coherence contract standby reads ride on).  Gate: zero
  violations; observed standby visibility lag is reported p50/p99.

Slow-host note: election timeouts are seconds-scale here ON PURPOSE —
the quorum, writer and prober share one GIL, and the gate must measure
failover, not scheduler jitter (same discipline as bench-metadata's
modeled fsync).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import List, Optional, Tuple

from alluxio_tpu_torch.stress.base import BenchResult, percentiles


def run(*, masters: int = 3, election_timeout_s: float = 2.0,
        warmup_s: float = 3.0, settle_s: float = 3.0,
        mttr_budget_timeouts: float = 2.0) -> BenchResult:
    import tempfile

    from alluxio_tpu_torch.minicluster.ha_cluster import HaCluster, WriteLedger
    from alluxio_tpu_torch.rpc.clients import FsMasterClient

    t_start = time.monotonic()
    lo = max(0.2, election_timeout_s / 2)
    # budget against the EFFECTIVE worst-member election timeout: rank
    # staggering (raft.py _reset_election_deadline: +rank * 15% of the
    # randomization band, split-vote avoidance) means the slowest
    # surviving member legitimately fires that much later than the
    # configured max — "2 election timeouts" must count what the
    # election design actually allows, not under-budget high ranks
    stagger_max = (masters - 1) * 0.15 * (election_timeout_s - lo)
    mttr_budget_s = mttr_budget_timeouts * (election_timeout_s
                                            + stagger_max)
    with tempfile.TemporaryDirectory() as base:
        cluster = HaCluster(
            base, num_masters=masters, num_workers=0,
            election_timeout=(f"{int(lo * 1000)}ms",
                              f"{int(election_timeout_s * 1000)}ms"))
        try:
            cluster.start()
            # max_sleep 0.5s: the default 3s backoff cap is tuned for
            # overload, not failover — one unlucky 2-3s sleep drawn just
            # as the new leader emerges would dominate the MTTR the gate
            # is trying to measure.  A real HA deployment tunes
            # atpu.user.rpc.retry.max.sleep the same way (docs/ha.md).
            writer = cluster.fs_client(retry_duration_s=60.0,
                                       max_sleep_s=0.5, fastpath=False)
            primary_reader = cluster.fs_client(retry_duration_s=10.0,
                                               max_sleep_s=0.5,
                                               fastpath=False)
            ledger = WriteLedger()
            acks: List[Tuple[str, float]] = []  # (path, t_ack)
            stop = threading.Event()
            writer_err: List[BaseException] = []
            writer.create_directory("/ha-bench")

            def write_loop() -> None:
                i = 0
                while not stop.is_set():
                    path = f"/ha-bench/w{i:06d}"
                    try:
                        writer.create_directory(path)
                    except BaseException as e:  # noqa: BLE001 gate input
                        writer_err.append(e)
                        return
                    t_ack = time.monotonic()
                    acks.append((path, t_ack))
                    # stamp a sample of writes for the staleness ledger
                    # (every write would double primary load)
                    if i % 5 == 0:
                        try:
                            _, stamp = primary_reader.get_status(
                                path, want_version=True)
                            ledger.record(path, stamp)
                        except Exception:  # noqa: BLE001 mid-failover
                            ledger.record(path, None)
                    else:
                        ledger.record(path, None)
                    i += 1
                    time.sleep(0.005)

            staleness_violations = 0
            standby_lag_s: List[float] = []
            seen_on_standby: dict = {}

            #: one probe client per standby port, reused across
            #: iterations: a fresh channel per 50ms tick adds setup
            #: jitter to the very lag percentiles the suite gates on
            probe_clients: dict = {}

            def probe_loop() -> None:
                nonlocal staleness_violations
                while not stop.is_set():
                    idxs = cluster.standby_indices()
                    port = None
                    for i in idxs:
                        m = cluster.masters[i]
                        if m is not None and m.standby_rpc_port:
                            port = m.standby_rpc_port
                            break
                    if port is None:
                        time.sleep(0.05)
                        continue
                    sc = probe_clients.get(port)
                    if sc is None:
                        sc = probe_clients[port] = FsMasterClient(
                            f"localhost:{port}", retry_duration_s=1.0,
                            fastpath=False)
                    try:
                        infos, stamp = sc.list_status(
                            "/ha-bench", want_version=True)
                    except Exception:  # noqa: BLE001 standby mid-churn
                        time.sleep(0.05)
                        continue
                    now = time.monotonic()
                    names = {"/ha-bench/" + x.name for x in infos}
                    staleness_violations += len(
                        ledger.staleness_violations(names, stamp))
                    for path, t_ack in list(acks):
                        if path in names and path not in seen_on_standby:
                            seen_on_standby[path] = now
                            standby_lag_s.append(max(0.0, now - t_ack))
                    time.sleep(0.05)

            wt = threading.Thread(target=write_loop, daemon=True)
            pt = threading.Thread(target=probe_loop, daemon=True)
            wt.start(), pt.start()
            time.sleep(warmup_s)
            t_kill = time.monotonic()
            cluster.kill_primary()
            # MTTR = kill START to the first ack landed after the old
            # primary is fully dead: an in-flight write acked inside the
            # server's stop grace must not read as an 18ms failover
            t_dead = time.monotonic()
            mttr_s: Optional[float] = None
            deadline = t_kill + 60.0
            while time.monotonic() < deadline and not writer_err:
                post = [t for _, t in acks if t > t_dead]
                if post:
                    mttr_s = post[0] - t_kill
                    break
                time.sleep(0.02)
            time.sleep(settle_s)  # let standby probing settle post-failover
            stop.set()
            wt.join(timeout=10), pt.join(timeout=10)

            lost = ledger.verify_durable(
                cluster.fs_client(retry_duration_s=30.0, fastpath=False))
            lag = percentiles(standby_lag_s)
            errors = 0
            if writer_err:
                errors += 1
                print(f"[ha] writer surfaced an error through failover: "
                      f"{writer_err[0]!r}", file=sys.stderr)
            if mttr_s is None:
                errors += 1
                print("[ha] no acknowledged write within 60s of the "
                      "kill — failover never completed", file=sys.stderr)
            elif mttr_s > mttr_budget_s:
                errors += 1
                print(f"[ha] MTTR {mttr_s:.2f}s exceeds the "
                      f"{mttr_budget_s:.2f}s budget "
                      f"({mttr_budget_timeouts:g} election timeouts)",
                      file=sys.stderr)
            if lost:
                errors += 1
                print(f"[ha] {len(lost)} ACKED writes missing after "
                      f"failover: {lost[:5]} ...", file=sys.stderr)
            if staleness_violations:
                errors += 1
                print(f"[ha] {staleness_violations} standby reads were "
                      f"staler than their advertised md_version",
                      file=sys.stderr)
            return BenchResult(
                bench="ha-failover",
                params={"masters": masters,
                        "election_timeout_s": election_timeout_s,
                        "mttr_budget_s": round(mttr_budget_s, 2)},
                metrics={
                    "mttr_s": round(mttr_s, 3) if mttr_s is not None
                    else None,
                    "mttr_ok": mttr_s is not None
                    and mttr_s <= mttr_budget_s,
                    "acked_writes": len(acks),
                    "lost_acked": len(lost),
                    "staleness_violations": staleness_violations,
                    "standby_reads_observed": len(standby_lag_s),
                    "standby_lag_p50_us": lag["p50_us"],
                    "standby_lag_p99_us": lag["p99_us"],
                },
                errors=errors,
                duration_s=time.monotonic() - t_start)
        finally:
            cluster.stop()
