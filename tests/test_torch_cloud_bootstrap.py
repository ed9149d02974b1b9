"""The port's cloud bootstrap actions (``deploy/torch/{cloud,dataproc,
emr}``) on the CPU: every case of ``tests/test_cloud_bootstrap.py``, run
on the port's scripts in ATPU_DRYRUN mode with env-injected metadata, so
the role dispatch, the properties written to ATPU_SITE_PROPERTIES (which
the port's shell reads) and the process plan are asserted without a
cloud VM; the ``build.sh``-inlined artifacts run standalone, without
their siblings. Each plan is also held against the JAX scripts' on the
same inputs: equal once the launcher's name is masked. A fetched wheel
keeps its own file name in the port's plan (pip reads the distribution
and its tags from it); the JAX plan renames every wheel to
``/tmp/alluxio_tpu.whl``."""

import json
import os
import shutil
import subprocess

from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script_path: str, env_extra: dict, args=()):
    env = dict(os.environ)
    env.update({"ATPU_DRYRUN": "1"})
    env.update(env_extra)
    r = subprocess.run(["bash", script_path, *args],
                       capture_output=True, text=True, env=env,
                       timeout=60)
    assert r.returncode == 0, r.stderr
    return r.stdout, r.stderr


def _deploy(script: str) -> str:
    return os.path.join(REPO, "deploy", "torch", script)


def _jax_deploy(script: str) -> str:
    return os.path.join(REPO, "deploy", script)


def _site(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            if "=" in line:
                k, _, v = line.strip().partition("=")
                out[k] = v
    return out


DATAPROC = "dataproc/alluxio-tpu-torch-dataproc.sh"
EMR = "emr/alluxio-tpu-torch-emr.sh"


class TestDataprocAction:
    def test_master_role_plan(self, tmp_path):
        site = str(tmp_path / "site.properties")
        out, err = _run(_deploy(DATAPROC), {
            "ATPU_SITE_PROPERTIES": site,
            "ATPU_MD_DATAPROC_ROLE": "Master",
            "ATPU_MD_DATAPROC_MASTER": "m-0.internal",
            "ATPU_ROOT_UFS": "gs://bkt/warehouse",
            "ATPU_WHEEL_URI": "gs://bkt/alluxio_tpu.whl",
            "ATPU_PROPERTIES":
                "atpu.security.authentication.type=SIMPLE",
        })
        assert "PLAN: gsutil cp gs://bkt/alluxio_tpu.whl" in out
        assert "PLAN: pip install /tmp/alluxio_tpu.whl" in out
        # roles start via the wheel's port console script
        assert "PLAN: alluxio-tpu-torch format" in out
        assert "PLAN: daemon alluxio-tpu-torch master" in out
        assert "PLAN: daemon alluxio-tpu-torch job-master" in out
        assert "daemon alluxio-tpu-torch worker" not in out
        assert "daemon alluxio-tpu " not in out
        props = _site(site)
        assert props["atpu.master.hostname"] == "m-0.internal"
        assert props["atpu.master.mount.table.root.ufs"] == \
            "gs://bkt/warehouse"
        assert props["atpu.security.authentication.type"] == "SIMPLE"
        assert props["atpu.worker.ramdisk.size"].endswith("MB")

    def test_worker_role_plan(self, tmp_path):
        site = str(tmp_path / "site.properties")
        out, _ = _run(_deploy(DATAPROC), {
            "ATPU_SITE_PROPERTIES": site,
            "ATPU_MD_DATAPROC_ROLE": "Worker",
            "ATPU_MD_DATAPROC_MASTER": "m-0.internal",
        })
        assert "PLAN: daemon alluxio-tpu-torch worker" in out
        assert "PLAN: daemon alluxio-tpu-torch job-worker" in out
        assert "format" not in out
        assert _site(site)["atpu.master.hostname"] == "m-0.internal"
        # no wheel uri -> index install of the distribution that holds
        # the port
        assert "PLAN: pip install alluxio-tpu" in out

    def test_operator_property_overrides_computed_default(
            self, tmp_path):
        site = str(tmp_path / "site.properties")
        _run(_deploy(DATAPROC), {
            "ATPU_SITE_PROPERTIES": site,
            "ATPU_MD_DATAPROC_ROLE": "Worker",
            "ATPU_MD_DATAPROC_MASTER": "m",
            "ATPU_PROPERTIES": "atpu.worker.ramdisk.size=32GB",
        })
        assert _site(site)["atpu.worker.ramdisk.size"] == "32GB"


class TestEmrAction:
    def test_master_from_instance_json_override(self, tmp_path):
        site = str(tmp_path / "site.properties")
        out, _ = _run(_deploy(EMR), {
            "ATPU_SITE_PROPERTIES": site,
            "ATPU_EMR_IS_MASTER": "true",
        }, args=["s3://bkt/wh", "s3://bkt/atpu.whl"])
        assert "PLAN: aws s3 cp s3://bkt/atpu.whl" in out
        # the wheel keeps its file name
        assert "PLAN: pip install /tmp/atpu.whl" in out
        assert "PLAN: daemon alluxio-tpu-torch master" in out
        assert _site(site)["atpu.master.mount.table.root.ufs"] == \
            "s3://bkt/wh"

    def test_worker_points_at_master_dns(self, tmp_path):
        site = str(tmp_path / "site.properties")
        out, _ = _run(_deploy(EMR), {
            "ATPU_SITE_PROPERTIES": site,
            "ATPU_EMR_IS_MASTER": "false",
            "ATPU_EMR_MASTER_HOST": "ip-10-0-0-1.ec2.internal",
        })
        assert "PLAN: daemon alluxio-tpu-torch worker" in out
        assert _site(site)["atpu.master.hostname"] == \
            "ip-10-0-0-1.ec2.internal"

    def test_worker_with_no_master_dns_fails_fast(self, tmp_path):
        env = dict(os.environ)
        env.update({"ATPU_DRYRUN": "1",
                    "ATPU_SITE_PROPERTIES":
                        str(tmp_path / "site.properties"),
                    "ATPU_EMR_IS_MASTER": "false",
                    "ATPU_EMR_MASTER_HOST": ""})
        r = subprocess.run(
            ["bash", _deploy(EMR)],
            capture_output=True, text=True, env=env, timeout=60)
        assert r.returncode != 0
        assert "FATAL" in r.stderr

    def test_emr_configuration_json_is_valid(self):
        with open(_deploy("emr/alluxio-tpu-torch-emr.json")) as f:
            doc = json.load(f)
        assert any(c["Classification"] == "spark-defaults"
                   for c in doc)
        # the runtime config contract, not a JVM fs.impl
        assert "ATPU_SITE_PROPERTIES" in json.dumps(doc)


class TestBuiltArtifactsAreSelfContained:
    def test_built_scripts_run_without_siblings(self, tmp_path):
        """build.sh inlines the common core; the artifact must run from
        a bare directory — exactly what a cloud VM downloads."""
        r = subprocess.run(
            ["bash", _deploy("cloud/build.sh")],
            capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, r.stderr
        for name, env in (
            ("alluxio-tpu-torch-dataproc.sh",
             {"ATPU_MD_DATAPROC_ROLE": "Worker",
              "ATPU_MD_DATAPROC_MASTER": "m"}),
            ("alluxio-tpu-torch-emr.sh",
             {"ATPU_EMR_IS_MASTER": "true"}),
        ):
            built = _deploy(os.path.join("dist", name))
            assert os.path.exists(built)
            with open(built) as f:
                body = f.read()
            assert "bootstrap-common.sh\"" not in body  # no sourcing
            assert "install_wheel()" in body  # core inlined
            lone = str(tmp_path / name)
            shutil.copy(built, lone)
            out, _ = _run(lone, {
                "ATPU_SITE_PROPERTIES":
                    str(tmp_path / f"{name}.properties"),
                **env})
            assert "daemon alluxio-tpu-torch" in out


def _plan(script: str, tmp_path, name: str, env: dict, args=()) -> tuple:
    site = str(tmp_path / f"{name}.properties")
    out, err = _run(script, {"ATPU_SITE_PROPERTIES": site, **env}, args)
    out = out.replace("alluxio-tpu-torch", "alluxio-tpu")
    err = [line.replace("alluxio-tpu-torch-bootstrap",
                        "alluxio-tpu-bootstrap").replace(site, "@SITE@")
           for line in err.splitlines()]
    return out, err, _site(site)


def test_plans_match_jax(tmp_path):
    """The same inputs through both packages' actions give the same plan,
    log and site file once the launcher's name is masked."""
    cases = [
        (DATAPROC, "dataproc/alluxio-tpu-dataproc.sh",
         {"ATPU_MD_DATAPROC_ROLE": "Master",
          "ATPU_MD_DATAPROC_MASTER": "m-0.internal",
          "ATPU_ROOT_UFS": "gs://bkt/warehouse",
          "ATPU_WHEEL_URI": "gs://bkt/alluxio_tpu.whl",
          "ATPU_PROPERTIES": "atpu.worker.ramdisk.size=32GB"}, ()),
        (DATAPROC, "dataproc/alluxio-tpu-dataproc.sh",
         {"ATPU_MD_DATAPROC_ROLE": "Worker",
          "ATPU_MD_DATAPROC_MASTER": "m"}, ()),
        (EMR, "emr/alluxio-tpu-emr.sh", {"ATPU_EMR_IS_MASTER": "true"},
         ("s3://bkt/wh", "https://host/alluxio_tpu.whl")),
        (EMR, "emr/alluxio-tpu-emr.sh",
         {"ATPU_EMR_IS_MASTER": "false",
          "ATPU_EMR_MASTER_HOST": "ip-10-0-0-1.ec2.internal"}, ()),
    ]
    for i, (port, jax, env, args) in enumerate(cases):
        got = _plan(_deploy(port), tmp_path, f"port{i}", env, args)
        want = _plan(_jax_deploy(jax), tmp_path, f"jax{i}", env, args)
        assert got == want, (port, env)
