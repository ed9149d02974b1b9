"""Share of the traced slice the loader's producer spent in
``atpu.loader.queue_put`` ranges, handing items over and blocked on a
full queue: high when the producer runs ahead of the consumer."""

from benchmark.metrics.loader_queue_wait_pct import slice_share_pct


def read(run):
    return slice_share_pct(run, "atpu.loader.queue_put")
