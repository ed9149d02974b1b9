"""Stripe planning (a copy of ``alluxio_tpu/utils/striping.py``), used by
the client's striped remote reads (``client/remote_read.py``) and, when
it is ported, the worker's striped cold fetch: one implementation, so
the striping math of the two halves of the data plane cannot diverge."""

from __future__ import annotations

from typing import List, Tuple


def plan_stripes(length: int, stripe_size: int) -> List[Tuple[int, int]]:
    """(range-relative offset, length) per stripe; empty for
    ``length <= 0`` — callers that need a completion event for empty
    ranges add their own sentinel."""
    if length <= 0:
        return []
    stripe_size = max(1, stripe_size)
    return [(off, min(stripe_size, length - off))
            for off in range(0, length, stripe_size)]
