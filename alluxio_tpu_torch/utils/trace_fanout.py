"""HA trace fan-out (a copy of ``alluxio_tpu/utils/trace_fanout.py``).

A trace's spans land on whichever master each node heartbeats to, which
on an HA deployment is not always the primary, so a single-master
``get_trace`` can show a hole exactly where the interesting hop ran.
These helpers query every configured master endpoint and merge the
stitched views back into one (dedup by ``(trace_id, span_id)``), which
is what ``/api/v1/master/trace?fanout=1`` serves on HA deployments
(every master of ``atpu.master.rpc.addresses``, standbys included: they
answer ``get_trace`` with their own spans).
"""

from __future__ import annotations

from typing import List, Sequence

from alluxio_tpu_torch.conf import Keys
from alluxio_tpu_torch.utils.tracing import summarize_traces


def master_endpoints(conf) -> List[str]:
    """Every configured master RPC endpoint (the HA list when set, else
    the single hostname:port)."""
    addrs = str(conf.get(Keys.MASTER_RPC_ADDRESSES) or "")
    eps = [a.strip() for a in addrs.split(",") if a.strip()]
    if not eps:
        eps = [f"{conf.get(Keys.MASTER_HOSTNAME)}:"
               f"{conf.get_int(Keys.MASTER_RPC_PORT)}"]
    return eps


def peer_traces(conf, *, limit: int = 500, prefix: str = "",
                trace_id: str = "",
                exclude: Sequence[str] = ()) -> List[dict]:
    """``get_trace`` against each master endpoint individually (no HA
    failover — the point is each member's own ring + store). A dead or
    unreachable member is skipped: a partial view beats no view during
    exactly the failovers this exists to debug."""
    from alluxio_tpu_torch.rpc.clients import MetaMasterClient

    results: List[dict] = []
    for ep in master_endpoints(conf):
        if ep in exclude:
            continue
        try:
            c = MetaMasterClient(ep, conf=conf, retry_duration_s=3.0)
            r = c.get_trace(limit=limit, prefix=prefix,
                            trace_id=trace_id)
        except Exception:  # noqa: BLE001 - dead member: skip
            continue
        for s in r.get("spans") or ():
            # disambiguate each member's own ring spans — "master"
            # alone would collapse three members into one source
            if s.get("source") == "master":
                s["source"] = f"master@{ep}"
        results.append(r)
    return results


def merge_stitched(base: dict, peers: Sequence[dict]) -> dict:
    """Merge peer ``get_trace`` responses into a base stitched view:
    union of spans (first occurrence wins), re-sorted most-recent-first,
    with the per-trace summary recomputed over the union."""
    spans: List[dict] = list(base.get("spans") or ())
    seen = {(s.get("trace_id"), s.get("span_id")) for s in spans}
    for r in peers:
        for s in r.get("spans") or ():
            key = (s.get("trace_id"), s.get("span_id"))
            if key in seen:
                continue
            seen.add(key)
            spans.append(s)
    spans.sort(key=lambda s: s.get("start_ms") or 0.0, reverse=True)
    return {"spans": spans, "traces": summarize_traces(spans)}
