"""Stress benchmark suite (a copy of ``alluxio_tpu/stress/``).

Re-design of the reference ``stress/`` module
(``stress/shell/src/main/java/alluxio/stress/cli/*``): each bench drives
one BASELINE.md config against an in-process LocalCluster (default) or a
live cluster (``--master``), and emits exactly one JSON result line on
stdout — the ``IOTaskSummary``/``MasterBenchSummary`` analogue. The
CLI (``python -m alluxio_tpu_torch.stress``) refuses the JAX benches
whose modules the port does not have yet (observability, HA, admission),
each with the ROADMAP item that brings it.

Nothing here imports torch: the metadata bench's capacity child runs
under an address-space cap that a torch import alone would exceed.
"""

from alluxio_tpu_torch.stress.base import BenchResult, drive, percentiles

__all__ = ["BenchResult", "drive", "percentiles"]
