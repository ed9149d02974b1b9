"""Seconds from process start to the first timed batch (host clock):
imports, the CUDA context, kernel builds, the cluster, the dataset
generated and written, and the warm-up epochs."""


def read(run):
    return run.setup_s
