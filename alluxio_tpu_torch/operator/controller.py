"""Dataset reconcile loop (a copy of
``alluxio_tpu/operator/controller.py``, over the port's ``FileSystem``
and job-master client).

Re-design of the reference K8s operator's dataset controller
(``integration/kubernetes/operator/alluxio/api/v1alpha1/
dataset_types.go`` CRD + its reconcilers): a level-triggered loop that
makes the cluster match each ``Dataset`` CR —

  create  -> mount every ``spec.mounts`` entry under
             ``/datasets/<name>/``, set ``replication_min`` from
             ``spec.replicas``, and (``spec.prefetchStrategy: Eager``)
             submit ONE distributedLoad per spec generation
  scale   -> ``spec.replicas`` change re-sets ``replication_min``; the
             master's ReplicationChecker re-balances copies
  delete  -> free + unmount + drop our finalizer (the CR carries
             ``alluxio-tpu.io/dataset-protection`` so data detaches
             before the object vanishes)

Status is written back (phase, ufsTotal, cachedPercent,
observedGeneration) via the CRD status subresource, level-triggered
like the reference's requeue-on-diff loops.

CRD (install via ``deploy/kubernetes/dataset-crd.yaml``):
  group ``data.alluxio-tpu.io``, version ``v1alpha1``, kind ``Dataset``.

The API client is stdlib urllib against the API server (in-cluster:
service-account token + CA; tests: a fake HTTP API server) — no
kubernetes-python dependency, per the no-new-deps rule.
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from alluxio_tpu_torch.utils.httperr import error_body

LOG = logging.getLogger(__name__)


class ConflictError(IOError):
    """409 from the API server: someone else wrote first. Benign —
    the next level-triggered pass re-reads and retries."""


GROUP = "data.alluxio-tpu.io"
VERSION = "v1alpha1"
PLURAL = "datasets"
FINALIZER = "alluxio-tpu.io/dataset-protection"

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class K8sApi:
    """Minimal typed access to the Dataset CRD (list / patch spec-level
    metadata / patch status subresource)."""

    def __init__(self, base_url: str = "", namespace: str = "",
                 token: str = "", ca_file: str = "",
                 timeout_s: float = 30.0) -> None:
        if not base_url:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if host:
                base_url = f"https://{host}:{port}"
        if not base_url:
            raise ValueError("no API server: pass base_url or run "
                             "in-cluster")
        self.base = base_url.rstrip("/")
        self.namespace = namespace or self._default_namespace()
        self._token = token or self._sa_token()
        self._timeout = timeout_s
        ctx: Optional[ssl.SSLContext] = None
        if self.base.startswith("https://"):
            ctx = ssl.create_default_context(
                cafile=ca_file or (os.path.join(_SA_DIR, "ca.crt")
                                   if os.path.exists(
                                       os.path.join(_SA_DIR, "ca.crt"))
                                   else None))
        self._ctx = ctx

    @staticmethod
    def _default_namespace() -> str:
        ns_file = os.path.join(_SA_DIR, "namespace")
        if os.path.exists(ns_file):
            with open(ns_file) as f:
                return f.read().strip()
        return "default"

    @staticmethod
    def _sa_token() -> str:
        tok_file = os.path.join(_SA_DIR, "token")
        if os.path.exists(tok_file):
            with open(tok_file) as f:
                return f.read().strip()
        return ""

    # -- plumbing ------------------------------------------------------------
    def _call(self, method: str, path: str,
              body: Optional[dict] = None,
              content_type: str = "application/merge-patch+json") -> dict:
        url = self.base + path
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        if data is not None:
            req.add_header("Content-Type", content_type)
        try:
            with urllib.request.urlopen(req, timeout=self._timeout,
                                        context=self._ctx) as r:
                return json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            detail = error_body(e, limit=300)
            if e.code == 409:
                raise ConflictError(
                    f"k8s {method} {path}: conflict {detail}") from None
            raise IOError(
                f"k8s {method} {path}: HTTP {e.code} {detail}") from None

    def _crd_path(self, name: str = "", sub: str = "") -> str:
        p = (f"/apis/{GROUP}/{VERSION}/namespaces/{self.namespace}"
             f"/{PLURAL}")
        if name:
            p += f"/{name}"
        if sub:
            p += f"/{sub}"
        return p

    # -- typed surface -------------------------------------------------------
    def list_datasets(self) -> List[dict]:
        return self._call("GET", self._crd_path()).get("items", [])

    def patch_metadata(self, name: str, metadata: dict) -> dict:
        return self._call("PATCH", self._crd_path(name),
                          {"metadata": metadata})

    def patch_status(self, name: str, status: dict) -> dict:
        return self._call("PATCH", self._crd_path(name, "status"),
                          {"status": status})


class DatasetController:
    """One reconcile pass = observe every Dataset CR, converge the
    cluster, write status. Level-triggered: safe to run as often as you
    like; every action is idempotent."""

    def __init__(self, api: K8sApi, fs, job_client=None,
                 mount_root: str = "/datasets") -> None:
        self._api = api
        self._fs = fs
        self._job = job_client
        self._root = mount_root.rstrip("/")
        #: dataset name -> generation whose prefetch was submitted
        self._prefetched: Dict[str, int] = {}

    # -- helpers -------------------------------------------------------------
    def _dataset_path(self, name: str) -> str:
        return f"{self._root}/{name}"

    def _mount_point(self, ds_name: str, mount: dict, idx: int) -> str:
        sub = mount.get("name") or mount.get("mountPoint", "").rstrip(
            "/").rsplit("/", 1)[-1] or f"mount{idx}"
        return f"{self._dataset_path(ds_name)}/{sub}"

    def _existing_mounts(self) -> Dict[str, dict]:
        return {m.alluxio_path: m for m in self._fs.get_mount_points()}

    # -- reconcile -----------------------------------------------------------
    def reconcile_once(self) -> int:
        """Returns the number of datasets acted on (for tests/metrics)."""
        acted = 0
        for ds in self._api.list_datasets():
            name = ds["metadata"]["name"]
            try:
                if self._reconcile_one(ds):
                    acted += 1
            except ConflictError as e:
                # another writer won; the next pass re-reads
                LOG.info("dataset %s: %s (will retry)", name, e)
            except Exception as e:  # noqa: BLE001 keep the loop alive
                LOG.exception("reconcile of dataset %s failed", name)
                try:
                    self._api.patch_status(name, {
                        "phase": "Failed",
                        "message": f"{type(e).__name__}: {e}"})
                except IOError:
                    pass
        return acted

    def _reconcile_one(self, ds: dict) -> bool:
        meta, spec = ds["metadata"], ds.get("spec", {})
        name = meta["name"]
        if meta.get("deletionTimestamp"):
            return self._teardown(ds)
        changed = self._ensure_finalizer(ds)
        # one observation per pass: the recursive listing and the mount
        # table feed replication, status AND mount pruning — re-reading
        # them per step would double the master load every tick
        mounts = self._existing_mounts()
        changed |= self._ensure_mounts(name, spec, mounts)
        files = self._walk_files(self._dataset_path(name))
        changed |= self._ensure_replication(name, spec, files)
        changed |= self._ensure_prefetch(name, meta, spec)
        self._write_status(name, meta, spec, files, mounts)
        return changed

    def _ensure_finalizer(self, ds: dict) -> bool:
        meta = ds["metadata"]
        fins = meta.get("finalizers") or []
        if FINALIZER in fins:
            return False
        # resourceVersion precondition: merge-patch replaces the array
        # wholesale, so a concurrent finalizer writer must 409 us (we
        # retry from a fresh read next pass) rather than be clobbered
        self._api.patch_metadata(meta["name"],
                                 {"finalizers": fins + [FINALIZER],
                                  "resourceVersion":
                                      meta.get("resourceVersion")})
        return True

    def _ensure_mounts(self, name: str, spec: dict,
                       existing: Dict[str, dict]) -> bool:
        changed = False
        desired = {}
        for i, m in enumerate(spec.get("mounts", [])):
            desired[self._mount_point(name, m, i)] = m
        for at, m in desired.items():
            if at in existing:
                continue
            parent = at.rsplit("/", 1)[0]
            self._fs.create_directory(parent, recursive=True,
                                      allow_exists=True)
            self._fs.mount(at, m["mountPoint"],
                           read_only=bool(m.get("readOnly")),
                           shared=bool(m.get("shared")),
                           properties=dict(m.get("options") or {}))
            LOG.info("dataset %s: mounted %s at %s", name,
                     m["mountPoint"], at)
            existing[at] = m
            changed = True
        # level-triggered both ways: a mount dropped from the spec is
        # freed + unmounted (stale creds/data must not stay exposed)
        prefix = self._dataset_path(name) + "/"
        for at in sorted(existing):
            if at.startswith(prefix) and at not in desired:
                try:
                    self._fs.free(at, recursive=True)
                except Exception:  # noqa: BLE001 best-effort
                    pass
                self._fs.unmount(at)
                existing.pop(at, None)
                LOG.info("dataset %s: unmounted %s (left the spec)",
                         name, at)
                changed = True
        return changed

    def _ensure_replication(self, name: str, spec: dict,
                            files: list) -> bool:
        replicas = spec.get("replicas")
        if replicas is None:
            return False
        # 0 is an explicit "release the copies": replication_min resets
        # so the checker stops re-creating them
        changed = False
        for info in files:
            if info.replication_min != int(replicas):
                self._fs.set_attribute(info.path,
                                       replication_min=int(replicas))
                changed = True
        return changed

    def _ensure_prefetch(self, name: str, meta: dict, spec: dict) -> bool:
        strategy = (spec.get("prefetchStrategy") or "Lazy").lower()
        if strategy not in ("eager", "always") or self._job is None:
            return False
        gen = int(meta.get("generation", 1))
        if self._prefetched.get(name) == gen:
            return False
        job_id = self._job.run({
            "type": "load", "path": self._dataset_path(name),
            "replication": int(spec.get("replicas") or 1),
            "recursive": True})
        self._prefetched[name] = gen
        LOG.info("dataset %s: submitted distributedLoad job %s "
                 "(generation %d)", name, job_id, gen)
        return True

    def _teardown(self, ds: dict) -> bool:
        meta = ds["metadata"]
        name = meta["name"]
        root = self._dataset_path(name)
        existing = self._existing_mounts()
        for at in sorted(existing):
            if at == root or at.startswith(root + "/"):
                try:
                    self._fs.free(at, recursive=True)
                except Exception:  # noqa: BLE001 freeing is best-effort
                    LOG.warning("dataset %s: free of %s failed",
                                name, at)
                self._fs.unmount(at)
                LOG.info("dataset %s: unmounted %s", name, at)
        try:
            self._fs.delete(root, recursive=True)
        except Exception:  # noqa: BLE001 already gone / never created
            pass
        fins = [f for f in (meta.get("finalizers") or [])
                if f != FINALIZER]
        self._api.patch_metadata(name, {
            "finalizers": fins,
            "resourceVersion": meta.get("resourceVersion")})
        self._prefetched.pop(name, None)
        return True

    # -- status --------------------------------------------------------------
    def _walk_files(self, path: str):
        try:
            infos = self._fs.list_status(path, recursive=True)
        except Exception:  # noqa: BLE001 nothing mounted yet
            return []
        return [i for i in infos if not i.folder]

    def _write_status(self, name: str, meta: dict, spec: dict,
                      files: list, mounts: Dict[str, dict]) -> None:
        total = sum(f.length for f in files)
        cached = sum(f.length * f.in_memory_percentage // 100
                     for f in files)
        n_mounts = len([
            at for at in mounts
            if at.startswith(self._dataset_path(name) + "/")
            or at == self._dataset_path(name)])
        phase = "Bound" if n_mounts >= len(spec.get("mounts", [])) \
            and spec.get("mounts") else "NotBound"
        self._api.patch_status(name, {
            "phase": phase,
            "ufsTotal": str(total),
            "cachedPercent": (100 * cached // total) if total else 0,
            "fileCount": len(files),
            "observedGeneration": int(meta.get("generation", 1)),
        })

    # -- loop ----------------------------------------------------------------
    def run_forever(self, interval_s: float = 10.0,
                    stop=None) -> None:
        while stop is None or not stop.is_set():
            try:
                self.reconcile_once()
            except Exception:  # noqa: BLE001 API server hiccup
                LOG.exception("reconcile pass failed")
            if stop is not None:
                stop.wait(interval_s)
            else:
                time.sleep(interval_s)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    from alluxio_tpu_torch.client.file_system import FileSystem
    from alluxio_tpu_torch.conf import Configuration

    p = argparse.ArgumentParser(
        prog="alluxio-tpu-operator",
        description="Dataset lifecycle controller (mount/prefetch/"
                    "replicate/teardown per Dataset CR)")
    p.add_argument("--master", required=True,
                   help="master host:port")
    p.add_argument("--job-master", default="",
                   help="job master host:port (default: the master's "
                        "host with the configured job-master port)")
    p.add_argument("--api-server", default="",
                   help="K8s API base URL (default: in-cluster)")
    p.add_argument("--namespace", default="")
    p.add_argument("--interval", type=float, default=10.0)
    p.add_argument("--once", action="store_true",
                   help="single reconcile pass (cron-style)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    api = K8sApi(args.api_server, namespace=args.namespace)
    conf = Configuration()
    fs = FileSystem(args.master, conf=conf)
    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.rpc.job_service import JobMasterClient

    # job master co-deploys with the master: default to the SAME host
    # (not the conf default 'localhost' — the operator usually runs in
    # its own pod) with the configured job-master port
    job_addr = args.job_master
    if not job_addr:
        master_host = args.master.rsplit(":", 1)[0]
        job_addr = (f"{master_host}:"
                    f"{conf.get_int(Keys.JOB_MASTER_RPC_PORT)}")
    job = JobMasterClient(job_addr)
    ctl = DatasetController(api, fs, job)
    if args.once:
        ctl.reconcile_once()
        return 0
    ctl.run_forever(args.interval)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
