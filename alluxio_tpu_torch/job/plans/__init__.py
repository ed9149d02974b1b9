"""Built-in plan definitions (a copy of ``alluxio_tpu/job/plans/``;
reference: ``job/server/.../job/plan/{load,migrate,persist,replicate,
transform,stress}``)."""

from __future__ import annotations


def register_builtin_plans(registry) -> None:
    from alluxio_tpu_torch.job.plans.load import LoadDefinition
    from alluxio_tpu_torch.job.plans.migrate import MigrateDefinition
    from alluxio_tpu_torch.job.plans.persist import PersistDefinition
    from alluxio_tpu_torch.job.plans.replicate import (
        EvictDefinition, MoveDefinition, ReplicateDefinition,
    )
    from alluxio_tpu_torch.job.plans.stressbench import StressBenchDefinition
    from alluxio_tpu_torch.job.plans.transform import TransformDefinition

    for plan in (LoadDefinition(), MigrateDefinition(), PersistDefinition(),
                 ReplicateDefinition(), EvictDefinition(), MoveDefinition(),
                 TransformDefinition(), StressBenchDefinition()):
        registry.register(plan)
