"""The bytes bound of the decoded batches over the device time of every
operation launched under a ``bench.decode`` range, traced slice."""

from benchmark import devtrace, roofline


def read(run):
    if run.events is None:
        return None
    decodes = devtrace.ranges(run.events, "bench.decode")
    owner = devtrace.launched_under(run.events, decodes)
    device_us = sum(ev["dur"] for ev in devtrace.device_events(run.events)
                    if ev["correlation"] in owner)
    if not decodes or device_us <= 0:
        return None
    cfg = run.cfg
    per_batch = roofline.decode_bytes(
        cfg["batch_size"], cfg["stored_record_bytes"],
        cfg["height"] * cfg["width"] * cfg["channels"], cfg["label_bytes"])
    batches = len({id(r) for r in owner.values()})
    return 100.0 * roofline.bound_s(batches * per_batch) / (device_us / 1e6)
