"""YARN ResourceManager REST client, stdlib-only (a copy of
``alluxio_tpu/yarn/client.py``).

Env-adapted analogue of the reference's submission client
(``integration/yarn/.../Client.java:96``): where the reference drives
the protobuf ``YarnClient``, this speaks the RM's public REST API
(``/ws/v1/cluster``) — the same dialect discipline as the repo's other
hand-rolled connectors (WebHDFS, Swift, Glue). Covers the submission
lifecycle: new-application, submit with an AM launch command, state
polling, and kill.
"""

from __future__ import annotations

import json
import logging
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence

from alluxio_tpu_torch.utils.httperr import error_body
from alluxio_tpu_torch.yarn.allocator import Container

logger = logging.getLogger(__name__)

_TERMINAL = {"FINISHED", "FAILED", "KILLED"}


class YarnRestError(RuntimeError):
    def __init__(self, status: int, body: str) -> None:
        super().__init__(f"RM REST error {status}: {body[:300]}")
        self.status = status


class YarnRestClient:
    """Talk to a ResourceManager at ``http://host:8088`` (default RM
    webapp port). Also exposes ``node_hosts``/``request_containers``/
    ``release`` so it can serve as the allocator's ``RmProtocol`` where
    the RM (or a gateway) offers container grants over REST."""

    def __init__(self, endpoint: str, timeout: float = 30.0) -> None:
        self._base = endpoint.rstrip("/")
        self._timeout = timeout

    # -- plumbing -----------------------------------------------------
    def _call(self, method: str, path: str,
              body: Optional[dict] = None) -> dict:
        url = f"{self._base}/ws/v1/cluster{path}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": "application/json"}
            if data else {})
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as r:
                raw = r.read()
        except urllib.error.HTTPError as e:
            # RM errors carry full Java stack traces operators need —
            # keep parity with the pre-helper unlimited read
            raise YarnRestError(e.code,
                                error_body(e, limit=1 << 20)) from e
        return json.loads(raw) if raw.strip() else {}

    # -- submission lifecycle (Client.java run()) ---------------------
    def new_application(self) -> str:
        out = self._call("POST", "/apps/new-application")
        return out["application-id"]

    def submit(self, app_id: str, name: str, am_command: str, *,
               memory_mb: int = 1024, vcores: int = 1,
               queue: str = "default",
               env: Optional[Dict[str, str]] = None) -> None:
        ctx = {
            "application-id": app_id,
            "application-name": name,
            "application-type": "ALLUXIO-TPU",
            "queue": queue,
            "am-container-spec": {
                "commands": {"command": am_command},
                "environment": {
                    "entry": [{"key": k, "value": v}
                              for k, v in (env or {}).items()],
                },
            },
            "resource": {"memory": memory_mb, "vCores": vcores},
        }
        self._call("POST", "/apps", ctx)

    def state(self, app_id: str) -> str:
        return self._call("GET", f"/apps/{app_id}/state")["state"]

    def kill(self, app_id: str) -> None:
        self._call("PUT", f"/apps/{app_id}/state", {"state": "KILLED"})

    def wait_for_state(self, app_id: str, wanted: Sequence[str],
                       timeout: float = 300.0,
                       poll_s: float = 1.0) -> str:
        deadline = time.monotonic() + timeout
        state = self.state(app_id)
        while time.monotonic() < deadline:
            if state in wanted or state in _TERMINAL:
                return state
            time.sleep(poll_s)
            state = self.state(app_id)
        raise TimeoutError(
            f"app {app_id} still {state} after {timeout}s")

    # -- RmProtocol (allocation over REST) ----------------------------
    def node_hosts(self) -> List[str]:
        out = self._call("GET", "/nodes")
        nodes = (out.get("nodes") or {}).get("node") or []
        return [n["nodeHostName"] for n in nodes
                if n.get("state", "RUNNING") == "RUNNING"]

    def request_containers(self, count: int, hosts: Sequence[str],
                           relax_locality: bool, *,
                           memory_mb: int = 1024,
                           vcores: int = 1) -> List[Container]:
        out = self._call("POST", "/containers/request", {
            "count": count, "hosts": list(hosts),
            "relax-locality": relax_locality,
            "resource": {"memory": memory_mb, "vCores": vcores},
        })
        return [Container(c["container-id"], c["host"])
                for c in out.get("containers", [])]

    def release(self, container_id: str) -> None:
        self._call("POST", f"/containers/{container_id}/release")
