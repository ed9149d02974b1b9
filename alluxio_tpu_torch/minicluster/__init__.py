"""Test cluster harnesses (reference: ``minicluster/``). The port has the
in-process ``LocalCluster``; the multi-process and HA clusters come with
their slices."""

from alluxio_tpu_torch.minicluster.local_cluster import LocalCluster  # noqa: F401
