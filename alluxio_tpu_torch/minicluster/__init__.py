"""Test cluster harnesses (reference: ``minicluster/``): the in-process
``LocalCluster`` and ``HaCluster``, and the ``MultiProcessCluster`` whose
roles run in their own processes."""

from alluxio_tpu_torch.minicluster.ha_cluster import (  # noqa: F401
    HaCluster, WriteLedger,
)
from alluxio_tpu_torch.minicluster.local_cluster import LocalCluster  # noqa: F401
from alluxio_tpu_torch.minicluster.multi_process import (  # noqa: F401
    MultiProcessCluster,
)
