"""The port's Helm chart (``deploy/torch/helm/alluxio-tpu-torch``)
against the JAX package's (``deploy/helm/alluxio-tpu``), rendered on the
CPU with the in-tree renderer (``tests/testutils/mini_helm.py``).

- Every case of ``tests/test_helm_chart.py`` runs on both charts.
- For each values variant those cases use, the two renders are equal once
  the port's name is masked (the image ``alluxio-tpu-torch``, the
  launcher ``bin/alluxio-tpu-torch``, the ``app.kubernetes.io/name``
  label) and the worker's scheduling is taken out: the port's worker
  DaemonSet selects the H100 GPU node pool
  (``cloud.google.com/gke-accelerator: nvidia-h100-80gb``) and tolerates
  its ``nvidia.com/gpu`` taint, where the JAX chart's selects the TPU
  pool.
- The port's worker requests no GPU: a training pod on the same host
  does, and reaches the worker over the node network and ``/dev/shm``.
"""

import copy
import os

import pytest
import yaml

import tests.test_helm_chart as jax_cases
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)
from tests.testutils.mini_helm import render_chart

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARTS = {"jax": os.path.join(ROOT, "deploy", "helm", "alluxio-tpu"),
          "port": os.path.join(ROOT, "deploy", "torch", "helm",
                               "alluxio-tpu-torch")}
CASES = sorted(n for n in dir(jax_cases.TestChartRendering)
               if n.startswith("test_"))
#: the values each JAX case renders with
VARIANTS = {
    "default": {},
    "single_master": {"master": {"count": 1}},
    "proxy_and_fuse": {"proxy": {"enabled": True, "replicas": 2},
                       "fuse": {"enabled": True}},
    "properties_and_scale": {
        "master": {"count": 5},
        "properties": {"atpu.worker.tieredstore.levels": "2",
                       "atpu.master.safemode.wait": "5s"}},
    "ufs_credentials": {"ufs": {"rootUri": "gs://bucket/root",
                                "credentialsSecret": "ufs-creds"}},
}
GPU_POOL = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
TPU_POOL = {"cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice"}


def _docs(chart: str, values: dict) -> list:
    return jax_cases._docs(render_chart(CHARTS[chart],
                                        copy.deepcopy(values)))


@pytest.mark.parametrize("chart", sorted(CHARTS))
@pytest.mark.parametrize("case", CASES)
def test_jax_case_on_both_charts(case, chart, monkeypatch):
    monkeypatch.setattr(jax_cases, "CHART", CHARTS[chart])
    getattr(jax_cases.TestChartRendering(), case)()


def _scheduling(docs: list) -> tuple:
    """Takes the worker DaemonSet's node selector and tolerations out of
    ``docs`` (in place) and returns them."""
    spec = jax_cases._by_kind(docs, "DaemonSet")[0]["spec"]["template"][
        "spec"]
    return spec.pop("nodeSelector", None), spec.pop("tolerations", None)


def _unname(docs: list) -> list:
    text = yaml.safe_dump_all(docs, sort_keys=True)
    assert "alluxio-tpu-torch" in text
    return list(yaml.safe_load_all(text.replace("alluxio-tpu-torch",
                                                "alluxio-tpu")))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_renders_match_jax_apart_from_name_and_pool(variant):
    jax_docs = _docs("jax", VARIANTS[variant])
    port_docs = _docs("port", VARIANTS[variant])
    assert _scheduling(jax_docs) == (TPU_POOL, None)
    selector, tolerations = _scheduling(port_docs)
    assert selector == GPU_POOL
    assert tolerations == [{"key": "nvidia.com/gpu", "operator": "Exists",
                            "effect": "NoSchedule"}]
    assert _unname(port_docs) == list(yaml.safe_load_all(
        yaml.safe_dump_all(jax_docs, sort_keys=True)))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_port_chart_runs_the_port(variant):
    """Every container runs the port's image through its launcher, and
    no container requests a GPU."""
    docs = _docs("port", VARIANTS[variant])
    containers = [c for d in docs if d["kind"] in (
        "StatefulSet", "DaemonSet", "Deployment")
        for c in d["spec"]["template"]["spec"]["containers"]]
    assert containers
    for c in containers:
        assert c["image"] == "alluxio-tpu-torch:latest"
        script = c["args"][0]
        assert f"exec bin/alluxio-tpu-torch {c['name']}" in script
        assert "bin/alluxio-tpu " not in script
        res = c.get("resources", {})
        assert not any("gpu" in k for part in res.values()
                       for k in part), res
