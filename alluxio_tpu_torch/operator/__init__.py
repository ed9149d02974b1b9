"""Kubernetes dataset-lifecycle operator, a copy of
``alluxio_tpu/operator/__init__.py`` (reference:
``integration/kubernetes/operator/alluxio/`` — the 7.8k-LoC Go
controller-runtime operator with ``Dataset``/``AlluxioRuntime`` CRDs).

Env-adapted design: the Helm chart (``deploy/helm/alluxio-tpu``) owns
RUNTIME deployment (masters/workers as StatefulSet/DaemonSet), so the
operator here reconciles only the DATASET lifecycle — mount, prefetch,
replication, teardown — as a small Python control loop speaking the
Kubernetes REST API with the stdlib. See ``controller.py``.
"""

from alluxio_tpu_torch.operator.controller import (  # noqa: F401
    DatasetController, K8sApi,
)
