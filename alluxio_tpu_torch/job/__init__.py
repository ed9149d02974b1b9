"""Job service: background data-movement jobs (a copy of
``alluxio_tpu/job/``; reference: ``job/``).

A job master accepts job configs, plans them into per-worker tasks via
``PlanDefinition.select_executors``, and job workers execute
``PlanDefinition.run_task`` — the two-phase SPI of
``job/server/src/main/java/alluxio/job/plan/PlanDefinition.java``.
"""

from alluxio_tpu_torch.job.wire import JobInfo, Status, TaskInfo  # noqa: F401
