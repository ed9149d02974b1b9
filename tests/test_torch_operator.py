"""The port's Kubernetes dataset operator
(``alluxio_tpu_torch/operator/``) against the JAX package's, on the CPU.

- every case of JAX's ``tests/test_operator.py``, run on each package
  against its own ``LocalCluster(start_job_service=True)`` and a
  ``FakeK8sApiServer``;
- the wire: every request each package's controller sends to the fake
  API server (method, path, JSON body) over one seeded sequence (a CR
  created with an Eager prefetch, reconciled, its spec changed, a 409
  race on a second CR, then the first deleted) is the same;
- the CRD's constants are the same in both packages.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

from tests.testutils.fake_k8s import FakeK8sApiServer
from tests.testutils.torch_deploy import (
    JAX, PACKAGES, PORT, mod, record_wire,
)
from tests.testutils.torch_ha import wait_for
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)


def _cluster(pkg, base):
    keys = mod(pkg, "conf").Keys
    return mod(pkg, "minicluster.local_cluster").LocalCluster(
        base, num_workers=1, start_job_service=True,
        start_worker_heartbeats=True,
        conf_overrides={keys.WORKER_BLOCK_HEARTBEAT_INTERVAL: "50ms"})


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return request.param


@pytest.fixture()
def cluster(pkg, tmp_path):
    with _cluster(pkg, str(tmp_path / "cluster")) as c:
        yield c


@pytest.fixture()
def k8s():
    with FakeK8sApiServer() as srv:
        yield srv


def _controller(pkg, k8s, cluster):
    op = mod(pkg, "operator")
    api = op.K8sApi(k8s.endpoint, namespace="default", token="test-token")
    return op.DatasetController(api, cluster.file_system(),
                                cluster.job_client())


def _finalizer(pkg):
    return mod(pkg, "operator.controller").FINALIZER


def _ufs_corpus(tmp_path, n=3, size=65536):
    root = tmp_path / "ufs-data"
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        (root / f"shard-{i}.bin").write_bytes(bytes([i]) * size)
    return str(root), n, size


# -- JAX's TestDatasetLifecycle, on each package ------------------------------
class TestDatasetLifecycle:
    def test_create_mount_prefetch_status(self, pkg, tmp_path, cluster,
                                          k8s):
        root, n, size = _ufs_corpus(tmp_path)
        k8s.create("imagenet", {
            "mounts": [{"mountPoint": root, "name": "train",
                        "readOnly": True}],
            "replicas": 1,
            "prefetchStrategy": "Eager"})
        ctl = _controller(pkg, k8s, cluster)
        assert ctl.reconcile_once() == 1

        fs = cluster.file_system()
        mounts = {m.alluxio_path for m in fs.get_mount_points()}
        assert "/datasets/imagenet/train" in mounts
        names = {i.name for i in
                 fs.list_status("/datasets/imagenet/train")}
        assert names == {f"shard-{i}.bin" for i in range(n)}

        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            ctl.reconcile_once()
            st = k8s.status_of("imagenet")
            if st.get("cachedPercent") == 100:
                break
            time.sleep(0.2)
        st = k8s.status_of("imagenet")
        assert st["phase"] == "Bound"
        assert st["ufsTotal"] == str(n * size)
        assert st["fileCount"] == n
        assert st["cachedPercent"] == 100
        assert st["observedGeneration"] == 1
        assert _finalizer(pkg) in k8s.objects["imagenet"]["metadata"][
            "finalizers"]

    def test_reconcile_is_idempotent(self, pkg, tmp_path, cluster, k8s):
        root, *_ = _ufs_corpus(tmp_path)
        k8s.create("ds", {"mounts": [{"mountPoint": root,
                                      "name": "m"}]})
        ctl = _controller(pkg, k8s, cluster)
        ctl.reconcile_once()
        before = len(cluster.file_system().get_mount_points())
        assert ctl.reconcile_once() == 0
        assert len(cluster.file_system().get_mount_points()) == before

    def test_scale_updates_replication_min(self, pkg, tmp_path, cluster,
                                           k8s):
        root, n, _ = _ufs_corpus(tmp_path)
        k8s.create("ds", {"mounts": [{"mountPoint": root, "name": "m"}],
                          "replicas": 1})
        ctl = _controller(pkg, k8s, cluster)
        ctl.reconcile_once()
        fs = cluster.file_system()
        k8s.update_spec("ds", {"mounts": [{"mountPoint": root,
                                           "name": "m"}],
                               "replicas": 2})
        assert ctl.reconcile_once() == 1
        for i in fs.list_status("/datasets/ds/m"):
            assert i.replication_min == 2

    def test_delete_frees_unmounts_and_strips_finalizer(
            self, pkg, tmp_path, cluster, k8s):
        root, *_ = _ufs_corpus(tmp_path)
        k8s.create("gone", {"mounts": [{"mountPoint": root,
                                        "name": "m"}]})
        ctl = _controller(pkg, k8s, cluster)
        ctl.reconcile_once()
        fs = cluster.file_system()
        assert any(m.alluxio_path == "/datasets/gone/m"
                   for m in fs.get_mount_points())

        k8s.delete("gone")
        assert "gone" in k8s.objects
        ctl.reconcile_once()
        assert not any(m.alluxio_path.startswith("/datasets/gone")
                       for m in fs.get_mount_points())
        assert not fs.exists("/datasets/gone")
        assert "gone" not in k8s.objects

    def test_failed_dataset_reports_status_and_loop_survives(
            self, pkg, tmp_path, cluster, k8s):
        k8s.create("bad", {"mounts": [{"mountPoint":
                                       "unknownscheme://x", "name":
                                       "m"}]})
        root, *_ = _ufs_corpus(tmp_path)
        k8s.create("good", {"mounts": [{"mountPoint": root,
                                        "name": "m"}]})
        ctl = _controller(pkg, k8s, cluster)
        ctl.reconcile_once()
        assert k8s.status_of("bad")["phase"] == "Failed"
        assert "NotSupported" in k8s.status_of("bad")["message"] or \
            k8s.status_of("bad")["message"]
        assert any(m.alluxio_path == "/datasets/good/m"
                   for m in cluster.file_system().get_mount_points())

    def test_scale_to_zero_releases_replication(self, pkg, tmp_path,
                                                cluster, k8s):
        root, n, _ = _ufs_corpus(tmp_path)
        k8s.create("z", {"mounts": [{"mountPoint": root, "name": "m"}],
                         "replicas": 2})
        ctl = _controller(pkg, k8s, cluster)
        ctl.reconcile_once()
        fs = cluster.file_system()
        assert all(i.replication_min == 2
                   for i in fs.list_status("/datasets/z/m"))
        k8s.update_spec("z", {"mounts": [{"mountPoint": root,
                                          "name": "m"}],
                              "replicas": 0})
        ctl.reconcile_once()
        assert all(i.replication_min == 0
                   for i in fs.list_status("/datasets/z/m"))

    def test_mount_dropped_from_spec_is_unmounted(self, pkg, tmp_path,
                                                  cluster, k8s):
        root_a, *_ = _ufs_corpus(tmp_path / "a")
        root_b, *_ = _ufs_corpus(tmp_path / "b")
        k8s.create("mm", {"mounts": [
            {"mountPoint": root_a, "name": "train"},
            {"mountPoint": root_b, "name": "val"}]})
        ctl = _controller(pkg, k8s, cluster)
        ctl.reconcile_once()
        fs = cluster.file_system()
        mounts = {m.alluxio_path for m in fs.get_mount_points()}
        assert {"/datasets/mm/train", "/datasets/mm/val"} <= mounts
        k8s.update_spec("mm", {"mounts": [
            {"mountPoint": root_b, "name": "val"}]})
        ctl.reconcile_once()
        mounts = {m.alluxio_path for m in fs.get_mount_points()}
        assert "/datasets/mm/train" not in mounts
        assert "/datasets/mm/val" in mounts
        assert k8s.status_of("mm")["phase"] == "Bound"

    def test_stale_finalizer_write_conflicts_not_clobbers(
            self, pkg, tmp_path, cluster, k8s):
        root, *_ = _ufs_corpus(tmp_path)
        k8s.create("c", {"mounts": [{"mountPoint": root,
                                     "name": "m"}]})
        ctl = _controller(pkg, k8s, cluster)
        real_list = ctl._api.list_datasets
        ctl._api.list_datasets = _racy(k8s, "c", real_list)
        ctl.reconcile_once()
        fins = k8s.objects["c"]["metadata"]["finalizers"]
        assert "other.io/protect" in fins
        ctl._api.list_datasets = real_list
        ctl.reconcile_once()
        fins = k8s.objects["c"]["metadata"]["finalizers"]
        assert "other.io/protect" in fins and _finalizer(pkg) in fins

    def test_eager_prefetch_resubmits_per_generation(
            self, pkg, tmp_path, cluster, k8s):
        root, *_ = _ufs_corpus(tmp_path)
        spec = {"mounts": [{"mountPoint": root, "name": "m"}],
                "prefetchStrategy": "Eager"}
        k8s.create("gen", spec)
        ctl = _controller(pkg, k8s, cluster)
        submitted = []
        real_run = ctl._job.run
        ctl._job = type("J", (), {"run": staticmethod(
            lambda cfg: (submitted.append(cfg), real_run(cfg))[1])})()
        ctl.reconcile_once()
        ctl.reconcile_once()
        assert len(submitted) == 1
        k8s.update_spec("gen", dict(spec))
        ctl.reconcile_once()
        assert len(submitted) == 2


def _racy(k8s, name, real_list):
    """A listing after which another controller adds its finalizer (and
    bumps the resourceVersion) before ours is patched: JAX's race."""
    def racy_list():
        items = real_list()
        obj = k8s.objects[name]["metadata"]
        if "other.io/protect" not in (obj.get("finalizers") or []):
            obj["finalizers"] = (obj.get("finalizers") or []) + \
                ["other.io/protect"]
            obj["resourceVersion"] = str(int(obj["resourceVersion"]) + 1)
        return items
    return racy_list


# -- the wire ------------------------------------------------------------------
SEED = 20261018


def _seeded_corpus(directory, rng, n):
    os.makedirs(directory, exist_ok=True)
    for i in range(n):
        size = int(rng.integers(1, 9)) * 16384
        rng.integers(0, 256, size=size, dtype=np.uint8).tofile(
            os.path.join(directory, f"part-{i:02d}.bin"))
    return str(directory)


def _fully_cached(fs, path):
    infos = [i for i in fs.list_status(path, recursive=True)
             if not i.folder]
    return bool(infos) and all(i.in_memory_percentage == 100
                               for i in infos)


def _operator_script(pkg: str, base) -> tuple:
    """The seeded sequence on ``pkg``'s cluster and controller: (the
    wire, the statuses after each pass, the CRs left)."""
    rng = np.random.default_rng(SEED)
    root = _seeded_corpus(base / "ufs-seq", rng, 4)
    root_b = _seeded_corpus(base / "ufs-race", rng, 3)
    statuses = []
    with _cluster(pkg, str(base / "cluster")) as cluster, \
            FakeK8sApiServer() as k8s:
        wire = record_wire(k8s)
        ctl = _controller(pkg, k8s, cluster)
        fs = cluster.file_system()

        def reconcile():
            acted = ctl.reconcile_once()
            statuses.append((acted, {n: k8s.status_of(n)
                                     for n in sorted(k8s.objects)}))

        # create, with an Eager prefetch: the status counts nothing
        # cached, then everything once the load job is done
        spec = {"mounts": [{"mountPoint": root, "name": "train",
                            "readOnly": True}],
                "replicas": 1, "prefetchStrategy": "Eager"}
        k8s.create("seq", spec)
        reconcile()
        wait_for(lambda: _fully_cached(fs, "/datasets/seq"), 30.0,
                 "the Eager load to cache every file")
        reconcile()
        # a spec change: replicas 0 and a new generation (a new load of
        # the cached files)
        k8s.update_spec("seq", dict(spec, replicas=0))
        reconcile()
        # a 409 race on a second CR, then a clean pass
        k8s.create("race", {"mounts": [{"mountPoint": root_b,
                                        "name": "m"}]})
        real_list = ctl._api.list_datasets
        ctl._api.list_datasets = _racy(k8s, "race", real_list)
        reconcile()
        ctl._api.list_datasets = real_list
        reconcile()
        # delete: free, unmount, strip the finalizer
        k8s.delete("seq")
        reconcile()
        left = sorted(k8s.objects)
        mounts = sorted(m.alluxio_path for m in fs.get_mount_points())
    return list(wire), statuses, left, mounts


def test_k8s_wire_is_equal_across_packages(tmp_path):
    want = _operator_script(JAX, tmp_path / "jax")
    got = _operator_script(PORT, tmp_path / "port")
    assert got == want
    wire, statuses, left, mounts = got
    assert left == ["race"]
    assert mounts == ["/", "/datasets/race/m"]
    assert [s["seq"]["cachedPercent"] for _, s in statuses[:2]] == [0, 100]
    # the teardown's last write strips the finalizer
    assert any(m == "PATCH" and p.endswith("/datasets/seq")
               and b.get("metadata", {}).get("finalizers") == []
               for m, p, b in wire)


def test_crd_constants_match():
    for name in ("GROUP", "VERSION", "PLURAL", "FINALIZER"):
        assert getattr(mod(PORT, "operator.controller"), name) == \
            getattr(mod(JAX, "operator.controller"), name)
