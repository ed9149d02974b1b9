"""Samples whose consumer work finished inside the window, over the
window; the window ends with the device synchronised (host clock). A
per-layer reading of the loader's pace where the host sets it, which
swings with the host's own speed from run to run."""


def read(run):
    return run.samples / run.window_s if run.window_s > 0 else None
