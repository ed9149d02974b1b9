"""Device-tier hits among the blocks the consumer took in the window
(program counters): the loader's consumer-side ``Client.InputStallCount``
by serving tier, ``hbm`` over all tiers. (``Client.JaxHbmHits`` counts
the same hits on the producer's side, up to its queue ahead of the
consumer when the window closes.)"""

TIERS = ("hbm", "shm", "remote", "ufs", "unknown")


def read(run):
    c = run.counters
    taken = sum(c.get(f"Client.InputStallCount.{t}", 0) for t in TIERS)
    if taken <= 0:
        return None
    return 100.0 * c.get("Client.InputStallCount.hbm", 0) / taken
