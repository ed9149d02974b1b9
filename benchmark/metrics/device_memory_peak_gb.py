"""The device memory the input path held at its peak, in GB: the
caching allocator's count of allocated bytes from after the dataset was
generated to the window's close (the device tier, the loader's
staging, the batches and decode's intermediates), which the training
job cannot use. Nothing on a run without a card."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes > 0 else None
